from .registry import ExtensionRegistry, Extension, builtin_registry

__all__ = ["ExtensionRegistry", "Extension", "builtin_registry"]
