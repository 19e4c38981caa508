from .json_prefix import JsonSchemaGuide

__all__ = ["JsonSchemaGuide"]
