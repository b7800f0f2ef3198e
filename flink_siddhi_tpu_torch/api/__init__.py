from .cep import SiddhiCEP, CEPEnvironment
from .stream import ExecutionStream, Row

__all__ = ["SiddhiCEP", "CEPEnvironment", "ExecutionStream", "Row"]
