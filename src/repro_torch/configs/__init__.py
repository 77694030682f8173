from .registry import ARCHS, ArchConfig, get, smoke

__all__ = ["ARCHS", "ArchConfig", "get", "smoke"]
