"""Control layer: the XML-driven run orchestration.  The config file is
the program."""

from tclb_tpu_torch.control.solver import Solver, run_config, run_config_string

__all__ = ["Solver", "run_config", "run_config_string"]
