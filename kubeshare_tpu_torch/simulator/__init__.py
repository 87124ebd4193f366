from .simulator import SimulationReport, run_trace, parse_trace

__all__ = ["SimulationReport", "run_trace", "parse_trace"]
