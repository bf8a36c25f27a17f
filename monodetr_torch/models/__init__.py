from .monodetr import MonoDETR, build_monodetr

__all__ = ["MonoDETR", "build_monodetr"]
