"""The port's full-width event streams of the sub-quadratic assigned LMs
(``mamba2-780m``, ``recurrentgemma-9b``) equal the JAX reference's, event
for event (``auto``): the LM recipe (a 2048-token prefill, then 4 sampled
decode steps), with each Mamba-2 mixer's and RG-LRU block's ``scan`` events
(``mamba2``, ``rglru`` in the prefill; ``mamba2_step``, ``rglru_step`` in
decode), their depthwise convs' grouped ``conv`` events, and
recurrentgemma's windowed attention events (a window of 2048 over 2048 keys
masks nothing in the prefill; each decode sample attends to its ring of
``min(cur + 1, 2048)`` rows).  The streams are traced on ``meta``."""

import pytest

from torch_trace_oracle import assert_streams_equal, port_events, reference_events


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_event_stream_equals_the_reference(arch):
    got = port_events(arch, "auto")
    assert_streams_equal(got, reference_events(arch, "auto"))
    n_rec = {"mamba2-780m": 48, "recurrentgemma-9b": 26}[arch]
    scans = [e for e in got if e.op == "scan"]
    # one scan event a recurrent layer in the prefill and in each of the 4 decode samples
    assert len(scans) == 5 * n_rec
    assert {e.name.split("/")[-1] for e in scans} == (
        {"mamba2", "mamba2_step"} if arch == "mamba2-780m" else {"rglru", "rglru_step"})
    assert scans[0].seq_len == 2048 and scans[-1].seq_len == 1
    convs = [e for e in got if e.op == "conv"]
    assert len(convs) == n_rec and all(not e.meta["fused"] for e in convs)
    attn = [e for e in got if e.op == "attention"]
    assert len(attn) == (0 if arch == "mamba2-780m" else 5 * 12)
    if attn:
        assert {e.seq_len for e in attn} == {2048}
