from repro_torch.runtime.fault_tolerance import FaultTolerantRunner, RunnerConfig, elastic_resume

__all__ = ["FaultTolerantRunner", "RunnerConfig", "elastic_resume"]
