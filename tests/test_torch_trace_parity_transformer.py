"""The port's full-width event streams of prod-image, Muse, Phenaki and
LLaMA2-7B equal the JAX reference's, event for event (``auto``): a latent
UNet with fixed heads, the parallel decoders' one traced pass scaled by
their steps, the LM's prefill plus 4 sampled decode steps."""

import pytest

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


@pytest.mark.parametrize("arch", ["prod-image", "muse", "phenaki", "llama2-7b"])
def test_event_stream_equals_the_reference(arch):
    assert_streams_equal(port_events(arch, "auto"), reference_events(arch, "auto"))
