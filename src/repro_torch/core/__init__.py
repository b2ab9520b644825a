"""The paper's primary contribution as a library, ported: a system-
characterization framework for multi-modal (TTI/TTV/LM) generation
workloads (``repro.core``).

Modules:
  tracer            -- operator-event recording while a model runs on
                       ``meta`` (the paper's profiler hooks, §III Tools)
  perf_model        -- per-op roofline-modeled time; Fig. 6 breakdowns
  amdahl            -- Flash-Attention speedup decomposition (Table II)
  prefill_decode    -- Table III prefill/decode correspondence
  seq_profile       -- §V sequence-length profiling (Fig. 7/8)
  analytical        -- §V closed-form memory/FLOPs model, O(L^4) law
  profiler_analysis -- the card's side: a ``torch.profiler`` record read by
                       kernel, category and scope (the reference's
                       ``hlo_analysis`` reads the compiled XLA artifact)
  characterize      -- the tracing entry points
"""

from repro_torch.core import (  # noqa: F401
    amdahl,
    analytical,
    characterize,
    perf_model,
    prefill_decode,
    profiler_analysis,
    seq_profile,
    tracer,
)
