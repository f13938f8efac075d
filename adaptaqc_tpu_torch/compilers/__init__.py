from .adapt_compiler import AdaptCompiler
from .adapt_config import AdaptConfig
from .adapt_result import AdaptResult

__all__ = ["AdaptCompiler", "AdaptConfig", "AdaptResult"]
