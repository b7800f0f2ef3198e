from .tape import Tape, TapeSpec, WireTape, build_tape, build_wire_tape
from .executor import Job
from .replay import ResidentReplay

__all__ = ["Tape", "TapeSpec", "WireTape", "build_tape", "build_wire_tape",
           "Job", "ResidentReplay"]
