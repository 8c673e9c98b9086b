from .buffer import Memory, bucket_size

__all__ = ["Memory", "bucket_size"]
