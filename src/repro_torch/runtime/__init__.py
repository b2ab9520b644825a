from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunnerConfig, elastic_resume
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor

__all__ = ["FaultTolerantRunner", "RunnerConfig", "StragglerConfig", "StragglerMonitor",
           "elastic_resume"]
