"""The port's host-only training modules against the reference:
``runtime/straggler.py`` and the single-device half of
``training/compression.py`` (int8 and top-k gradient compression with error
feedback).

The reference's cases (``tests/test_substrate.py``) run on the port, and
the reference's own functions are the oracle on seeded arrays: the int8
payload and scales equal, the residuals equal, and top-k picking the
reference's indices where magnitudes tie (``jax.lax.top_k`` takes the lower
index first; ``torch.topk`` does not promise to)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.straggler import StragglerMonitor as JStragglerMonitor
from repro.training import compression as j_comp
from repro_torch.runtime import StragglerConfig, StragglerMonitor
from repro_torch.training import AdamWConfig, adamw_init, adamw_update
from repro_torch.training import compression as comp


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Straggler monitor
# ---------------------------------------------------------------------------


def test_straggler_detection_and_remesh_plan():
    """The reference's case (``tests/test_substrate.py``)."""
    mon = StragglerMonitor(n_hosts=8)
    for _ in range(20):
        for h in range(8):
            mon.record(h, 1.0 if h != 3 else 2.5)  # host 3 is slow
    assert mon.stragglers() == [3]
    plan = mon.plan_remesh(data_axis=8)
    assert plan["action"] == "remesh"
    assert plan["new_data_axis"] == 4  # power-of-two shrink fitting 7 hosts
    assert 3 not in plan["healthy_hosts"]


def test_straggler_monitor_follows_the_reference_on_random_step_times():
    rng = np.random.default_rng(0)
    cfg = StragglerConfig(ewma_alpha=0.3, threshold=1.3, min_samples=5)
    ours, ref = StragglerMonitor(6, cfg), JStragglerMonitor(6, cfg)
    assert ours.median() == ref.median() == 0.0 and ours.stragglers() == []
    slow = {1: 1.6, 4: 1.2}
    for step in range(30):
        for h in rng.permutation(6)[: 5 if step % 3 else 6]:  # a host skips some steps
            t = float(rng.uniform(0.9, 1.1) * slow.get(int(h), 1.0))
            ours.record(int(h), t)
            ref.record(int(h), t)
        assert ours.ewma == ref.ewma and ours.median() == ref.median()
        assert ours.stragglers() == ref.stragglers()
        for axis in (8, 6, 4):
            assert ours.plan_remesh(axis) == ref.plan_remesh(axis)
    assert 1 in ours.stragglers()


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def _grads(rng, scale=1.0):
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": (scale * rng.standard_normal(7)).astype(np.float32)}


def test_int8_with_error_feedback_equals_the_reference():
    """Five steps of compress -> decompress with the residual carried: the
    int8 payload, the scales, the residuals and the decompressed gradients
    equal the reference's."""
    rng = np.random.default_rng(1)
    first = _grads(rng)
    err = comp.init_error_feedback({k: torch.from_numpy(v) for k, v in first.items()})
    j_err = j_comp.init_error_feedback({k: jnp.asarray(v) for k, v in first.items()})
    for step in range(5):
        g = first if step == 0 else _grads(rng, scale=10.0 ** (step - 2))
        wire, err = comp.compress_int8({k: torch.from_numpy(v) for k, v in g.items()}, err)
        j_wire, j_err = j_comp.compress_int8({k: jnp.asarray(v) for k, v in g.items()}, j_err)
        out, j_out = comp.decompress_int8(wire), j_comp.decompress_int8(j_wire)
        for k in g:
            assert wire["q"][k].dtype == torch.int8
            np.testing.assert_array_equal(wire["q"][k].numpy(), np.asarray(j_wire["q"][k]))
            np.testing.assert_array_equal(wire["scale"][k].numpy(),
                                          np.asarray(j_wire["scale"][k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(j_err[k]))
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]))


def test_int8_rounds_half_to_even_as_the_reference():
    g = {"x": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])}  # scale 1 + 1e-12
    wire, _ = comp.compress_int8(g, comp.init_error_feedback(g))
    j_wire, _ = j_comp.compress_int8({"x": jnp.asarray(g["x"].numpy())},
                                     {"x": jnp.zeros(6, jnp.float32)})
    assert wire["q"]["x"].tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(wire["q"]["x"].numpy(), np.asarray(j_wire["q"]["x"]))


def test_int8_error_feedback_training_converges():
    """The reference's case on the port's AdamW: int8-EF-compressed
    gradients reach (near) the optimum the exact ones reach."""
    target = torch.tensor([1.0, -2.0, 3.0, 0.5])

    def grads_of(w):
        return {"w": 2 * (w["w"] - target)}

    def run(compressed: bool, steps=60):
        w = {"w": torch.zeros(4)}
        err = comp.init_error_feedback(grads_of(w))
        opt = adamw_init(w)
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=steps)
        for _ in range(steps):
            g = grads_of(w)
            if compressed:
                wire, err = comp.compress_int8(g, err)
                g = comp.decompress_int8(wire)
            w, opt, _ = adamw_update(w, g, opt, cfg)
        return w["w"]

    exact, compressed = run(False), run(True)
    assert float((compressed - target).abs().max()) < 0.1
    assert float((compressed - exact).abs().max()) < 0.1


def test_topk_picks_the_references_indices_where_magnitudes_tie():
    """Equal magnitudes of both signs around the k-th place: the kept
    indices, values and residual equal the reference's."""
    g = np.array([[0.5, -2.0, 2.0, 0.5], [-0.5, 2.0, 1.0, -1.0], [2.0, 0.5, -0.5, 1.0]],
                 np.float32)
    e = np.zeros_like(g)
    e[1, 2] = 1.0  # ties after the error feedback too: 1.0 + 1.0 = 2.0
    for k_frac in (0.25, 0.4, 0.5):
        (vals, idx), err = comp.compress_topk(torch.from_numpy(g), torch.from_numpy(e), k_frac)
        (j_vals, j_idx), j_err = j_comp.compress_topk(jnp.asarray(g), jnp.asarray(e), k_frac)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(j_vals))
        np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))
        np.testing.assert_array_equal(comp.decompress_topk((vals, idx), g.shape).numpy(),
                                      np.asarray(j_comp.decompress_topk((j_vals, j_idx),
                                                                        g.shape)))
    (_, idx), _ = comp.compress_topk(torch.from_numpy(g), torch.from_numpy(e), 0.4)
    assert idx.tolist() == [1, 2, 5, 6]  # k = 4 of the five 2.0s: the lowest indices


def test_topk_error_feedback_keeps_what_was_not_sent():
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    (vals, idx), err = comp.compress_topk(g, torch.zeros_like(g), 0.1)
    assert vals.numel() == 12
    torch.testing.assert_close(comp.decompress_topk((vals, idx), g.shape) + err, g,
                               rtol=0, atol=0)


def test_wire_bytes_int8_counts_one_byte_an_element():
    rng = np.random.default_rng(4)
    g = _grads(rng)
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    assert comp.wire_bytes_int8(t) == 37 == j_comp.wire_bytes_int8(
        {k: jnp.asarray(v) for k, v in g.items()})
