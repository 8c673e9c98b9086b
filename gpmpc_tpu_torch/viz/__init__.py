from .visu import ControlVisualizations

__all__ = ["ControlVisualizations"]
