from .reader import BitReader

__all__ = ["BitReader"]
