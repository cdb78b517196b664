from .boxes import generate_boxes

__all__ = ["generate_boxes"]
