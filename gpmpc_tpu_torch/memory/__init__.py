from .buffer import bucket_size

__all__ = ["bucket_size"]
