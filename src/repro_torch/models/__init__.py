from . import attention, blocks, layers, steps

__all__ = ["attention", "blocks", "layers", "steps"]
