"""Imagen's full-width event stream (base UNet, SR to 256 and 1024 px)
equals the JAX reference's event for event, and so do the handoff events of
reduced Stable Diffusion served through each package's ``CascadePipeline``:
one ``other`` event of twice the payload per stage-to-stage batch."""

import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.core import tracer as j_tracer
from repro.pipeline.cascade import CascadePipeline as JCascadePipeline
from repro.workload import reduced_workload as j_reduced_workload
from repro_torch.configs import get_config
from repro_torch.core import tracer
from repro_torch.pipeline.cascade import CascadePipeline
from repro_torch.workload import reduced_workload
from torch_trace_oracle import assert_streams_equal, port_events, reference_events

# two prompts of one length: one batch of 2 in each stage; a third alone
PROMPTS = [np.arange(5) % 100, (np.arange(5) + 3) % 100, np.arange(9) % 100]


def test_event_stream_equals_the_reference():
    assert_streams_equal(port_events("imagen", "auto"), reference_events("imagen", "auto"))


def _serve(cascade, wl, params):
    pipe = cascade(wl, params, pod_size=2)
    for rid, p in enumerate(PROMPTS):
        pipe.submit(rid, p)
    pipe.run()


def test_cascade_handoff_events_equal_the_reference():
    """Both pipelines run abstractly: the reference's under
    ``jax.eval_shape``, the port's with its weights on ``meta``."""
    jwl = j_reduced_workload(j_get_config("stable-diffusion"))
    with j_tracer.trace() as jtr:
        jax.eval_shape(lambda p: _serve(JCascadePipeline, jwl, p),
                       jax.eval_shape(jwl.model.init, jax.random.PRNGKey(0)))
    wl = reduced_workload(get_config("stable-diffusion"))
    with tracer.trace() as tr:
        _serve(CascadePipeline, wl, wl.model)
    want, got = ([e for e in t.events if e.name.startswith("handoff/")] for t in (jtr, tr))
    assert [e.name for e in want] == ["handoff/text_encoder->denoise", "handoff/denoise->vae"] * 2
    assert_streams_equal(got, want)
