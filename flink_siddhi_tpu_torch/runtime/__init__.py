from .tape import Tape, TapeSpec, build_tape
from .executor import Job

__all__ = ["Tape", "TapeSpec", "build_tape", "Job"]
