from .circuit import Circuit, Instruction
from . import gates

__all__ = ["Circuit", "Instruction", "gates"]
