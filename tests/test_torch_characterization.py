"""The port's characterization framework on its own event streams (no JAX):
the counterparts of ``tests/test_characterization.py``'s paper claims C1-C5
on full-size models traced on ``meta``, the tracer's mechanics, the
perf-model constants, and ``core.profiler_analysis``'s reading of a
profile (its name table on the kernel names the card run shows)."""

import dataclasses
import math
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.suite import with_dtype
from repro_torch.core import (
    amdahl,
    analytical,
    characterize,
    perf_model,
    prefill_decode,
    profiler_analysis,
    seq_profile,
    tracer,
)
from repro_torch.models.diffusion import ddim_step
from repro_torch.workload import workload_for

HARDWARE = [perf_model.TPU_V5E, perf_model.H100_SXM]


@pytest.fixture(scope="module")
def sd_events():
    """Stable Diffusion in bf16, full width, through ``generate`` on meta:
    the baseline (``naive``) and the flash (``blocked_jax``) streams."""
    wl = workload_for(with_dtype(get_config("stable-diffusion"), torch.bfloat16))
    return (characterize.trace_generative(wl, impl="naive"),
            characterize.trace_generative(wl, impl="blocked_jax"))


@pytest.mark.parametrize("hw", HARDWARE, ids=lambda h: h.name)
def test_c1_conv_dominates_post_flash(sd_events, hw):
    """Paper C1: after Flash Attention the bottleneck shifts to convolution."""
    _, flash = sd_events
    fb = perf_model.breakdown_fraction(flash, hw)
    assert max(fb, key=fb.get) == "conv"
    assert fb["attention"] < 0.3  # paper: 13-25 % after flash


@pytest.mark.parametrize("hw", HARDWARE, ids=lambda h: h.name)
def test_c2_flash_speedup_in_plausible_range(sd_events, hw):
    base, flash = sd_events
    rep = amdahl.flash_speedup(base, flash, hw)
    assert 1.2 < rep.e2e_speedup < 5.0
    # Amdahl consistency: the prediction from the attention share and the
    # attention speedup is the measured speedup (the streams differ in
    # attention only)
    assert abs(rep.amdahl_predicted - rep.e2e_speedup) / rep.e2e_speedup < 0.05


def test_c3_diffusion_is_prefill_like(sd_events):
    base, _ = sd_events
    assert prefill_decode.classify(base)["regime"] == "prefill-like"


def test_c4_seq_len_varies_ushape(sd_events):
    """Paper C4: highly variable sequence length, U-shaped over a UNet pass."""
    base, _ = sd_events
    prof = seq_profile.self_attention_profile(base)
    assert prof.variation >= 4.0  # paper: "up to 4x" (the trace shows 64x)
    assert prof.max_seq == 4096  # the 64x64 latent of a 512 px image
    period = seq_profile.fundamental_period(prof.seq_lens)
    mid = period.index(min(period))
    assert 0 < mid < len(period) - 1


def test_c5_memory_scaling_exponent_is_4():
    exp = analytical.attn_memory_scaling_exponent([32, 64, 128, 256])
    assert 3.5 < exp <= 4.05


def test_analytic_profile_matches_traced(sd_events):
    base, _ = sd_events
    traced = seq_profile.self_attention_profile([e for e in base if e.name.startswith("denoise")])
    cfg = get_config("stable-diffusion")
    pred = analytical.unet_seq_profile(cfg.latent_size, cfg.unet.channel_mult,
                                       cfg.unet.num_res_blocks, cfg.unet.attn_levels)
    assert sorted(set(pred)) == sorted(set(traced.seq_lens))


def test_tracer_scaling_by_denoise_steps(sd_events):
    base, _ = sd_events
    steps = get_config("stable-diffusion").denoise_steps
    denoise = [e for e in base if e.name.startswith("denoise/")]
    assert denoise and all(e.repeats == steps for e in denoise)
    assert all(e.repeats == 1 for e in base if not e.name.startswith("denoise/"))


def test_auto_stream_is_the_fused_one(sd_events):
    """``auto`` (the kernel tier) traces the fused structure: fused convs,
    GroupNorm statistics folded into them, flash attention."""
    wl = workload_for(with_dtype(get_config("stable-diffusion"), torch.bfloat16))
    auto = characterize.trace_generative(wl, impl="auto")
    convs = [e for e in auto if e.op == "conv"]
    assert convs and all(e.meta == {"impl": "pallas", "fused": True} for e in convs)
    assert {e.meta["impl"] for e in auto if e.op == "attention"} == {"pallas"}
    assert any(e.name.endswith("gn1_stats") for e in auto)
    # fusing moves fewer bytes than the unfused baseline, the same FLOPs
    base, flash = sd_events
    assert perf_model.total_bytes(auto) < perf_model.total_bytes(flash)
    conv_flops = lambda ev: sum(e.total_flops for e in ev if e.op == "conv")  # noqa: E731
    assert conv_flops(auto) == conv_flops(flash)


def test_muse_parallel_decode_constant_seq():
    cfg = with_dtype(get_config("muse"), torch.bfloat16)
    ev = characterize.trace_generative(workload_for(cfg), impl="blocked_jax")
    decode_ev = [e for e in ev if e.name.startswith("parallel_decode")]
    prof = seq_profile.self_attention_profile(decode_ev)
    # a flat profile (paper Fig. 7): every decode-stage self-attention call
    # runs the full constant image-token sequence
    assert set(prof.seq_lens) == {cfg.image_tokens}
    assert all(e.repeats == cfg.parallel_steps for e in decode_ev)


def test_full_size_parti_traces_with_no_parameter_memory():
    """Parti's 21.9 B parameters stay on ``meta`` while its full-width
    stream is traced: nothing is allocated for them."""
    wl = workload_for(with_dtype(get_config("parti"), torch.bfloat16))
    params = list(wl.model.parameters())
    assert sum(p.numel() for p in params) > 21e9
    ev = characterize.trace_generative(wl, impl="auto")
    assert all(p.device.type == "meta" for p in wl.model.parameters())
    assert prefill_decode.classify(ev)["regime"] == "decode-like"
    # the sampled decode steps grow the cache linearly (Fig. 7, Parti)
    lens = sorted({e.seq_len for e in ev if e.name.startswith("ar_decode/")
                   and e.name.endswith("/attn")})
    assert lens == [1, 128, 256, 384, 512, 640, 768, 896]
    decode = [e for e in ev if e.name.startswith("ar_decode/")]
    assert all(e.repeats == 128 for e in decode)


def test_lm_trace_is_mixed_prefill_and_decode():
    ev = characterize.trace_generative(workload_for(get_config("llama2-7b")), impl="auto")
    names = {e.name.split("/")[0] for e in ev}
    assert names == {"prefill", "decode"}
    decode_attn = [e for e in ev if e.name.startswith("decode/") and e.op == "attention"]
    assert {e.seq_len for e in decode_attn} == {2049, 2065, 2081, 2097}
    assert all(e.repeats == 16 and e.meta["impl"] == "decode" for e in decode_attn)
    assert prefill_decode.classify(ev)["regime"] == "decode-like"


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


def test_record_is_a_no_op_without_a_trace():
    assert not tracer.active()
    tracer.record("linear", "x", flops=1.0, bytes_hbm=1.0)
    assert tracer.scope("a").__class__.__name__ == "nullcontext"


def test_scopes_prefix_names_and_nested_traces_both_record():
    with tracer.trace() as outer:
        with tracer.scope("stage"):
            tracer.record("linear", "a", flops=2.0, bytes_hbm=4.0)
            with tracer.trace() as inner, tracer.scope("layer0"):
                tracer.record("conv", "b", flops=1.0, bytes_hbm=1.0, impl="pallas")
    assert [e.name for e in outer.events] == ["stage/a", "stage/layer0/b"]
    assert [e.name for e in inner.events] == ["layer0/b"]
    assert inner.events[0].meta == {"impl": "pallas"}


def test_scale_since_scales_one_pass():
    with tracer.trace() as tr:
        tracer.record("linear", "before", flops=1.0, bytes_hbm=1.0)
        t0 = len(tr.events)
        tracer.record("linear", "step", flops=3.0, bytes_hbm=5.0)
        tracer.scale_since(t0, 50)
    assert [e.repeats for e in tr.events] == [1, 50]
    assert tr.events[1].total_flops == 150.0 and tr.events[1].total_bytes == 250.0


def test_scope_opens_a_profiler_range_only_while_profiling():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.scope("denoise"):
            torch.ones(4).sum()
    assert any(e.name == "denoise" for e in prof.events())


def test_dtype_bytes_and_chrome_trace():
    assert tracer.dtype_bytes(torch.bfloat16) == 2 and tracer.dtype_bytes(torch.float32) == 4
    with tracer.trace() as tr, tracer.scope("text_encoder"):
        tracer.record("linear", "wq", flops=2e12, bytes_hbm=1e6)
    events = tr.to_chrome_trace()
    x = [e for e in events if e["ph"] == "X"]
    assert x[0]["name"] == "text_encoder/wq"
    assert x[0]["dur"] == pytest.approx(2e12 / (67e12 * 0.85) * 1e6)


def test_ddim_step_promotes_a_bf16_latent_as_jnp():
    z = torch.ones(2, 2, dtype=torch.bfloat16)
    a = torch.tensor(0.5)
    assert ddim_step(z, z, a, a).dtype == torch.float32
    assert ddim_step(z.float(), z.float(), a, a).dtype == torch.float32


# ---------------------------------------------------------------------------
# Perf model constants
# ---------------------------------------------------------------------------


def test_h100_constants():
    assert perf_model.H100_SXM.peak_flops == 989e12 and perf_model.H100_SXM.hbm_bw == 3.35e12
    assert perf_model.H100_SXM.hbm_bytes == 80 * 2**30
    assert perf_model.H100_SXM_FP32.peak_flops == 67e12
    assert perf_model.H100_SXM_FP32.hbm_bw == perf_model.H100_SXM.hbm_bw
    assert {f.name for f in dataclasses.fields(perf_model.Hardware)} == {
        "name", "peak_flops", "hbm_bw", "ici_bw", "hbm_bytes", "vmem_bytes"}


def test_op_time_is_the_roofline_term():
    e = tracer.OpEvent("linear", "x", flops=8.5e12, bytes_hbm=3.35e9, repeats=2)
    hw = perf_model.H100_SXM_FP32
    assert perf_model.op_time(e, hw) == pytest.approx(max(17e12 / (67e12 * 0.85), 6.7e9 / 3.35e12))
    slow = dataclasses.replace(e, flops=0.0, meta={"bw_efficiency": 0.5})
    assert perf_model.op_time(slow, hw) == pytest.approx(4e-3)


# ---------------------------------------------------------------------------
# profiler_analysis: reading a profile of the card
# ---------------------------------------------------------------------------

# Kernel names as a profile of the card showed them (chip_smoke.py phase
# 6c on the H100, summary.json "characterize": the hand kernels of
# csrc/*.cu, cuBLAS / cuBLASLt / CUTLASS, ATen), each with its category.
CARD_KERNELS = {
    'sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3_warpsize4x2x1_ffma_aligna'
    '4_alignc4_execute_kernel__5x_cublas': 'linear',
    'void (anonymous namespace)::conv2d_kernel<float, 128, 128>((anonymous namespace)::Conv<f'
    'loat>)': 'conv',
    'void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(cutlass_80_simt_sgemm'
    '_256x128_8x4_nn_align1::Params)': 'linear',
    'void (anonymous namespace)::fa_kernel<float, 128>((anonymous namespace)::Params)': 'attention',
    'void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::nativ'
    'e::CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<float> '
    'const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::native::CUDAFuncto'
    'r_add<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add<float> const&)::{lam'
    'bda(int)#1})': 'pointwise',
    'void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MeanOps<f'
    'loat, float, float, float>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, at:'
    ':native::MeanOps<float, float, float, float>, unsigned int, float, 4, 4>)': 'norm',
    '(anonymous namespace)::producer_kernel(float const*, float const*, float const*, float*,'
    ' int, int, int, int)': 'conv',
    'void sgemm_largek_lds64<false, false, 6, 3, 4, 5, 2, 64>(float*, float const*, float con'
    'st*, int, int, int, int, int, int, float const*, float const*, float, float, int, int, i'
    'nt*, int*)': 'linear',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anon'
    'ymous namespace)::OpaqueType<4u>, unsigned int, 4, 128, 1, 16, 4>(char*, at::native::(an'
    'onymous namespace)::CatArrInputTensorMetadata<at::native::(anonymous namespace)::OpaqueT'
    'ype<4u>, unsigned int, 128, 1>, at::native::(anonymous namespace)::TensorSizeStride<unsi'
    'gned int, 4u>, int, unsigned int)': 'other',
    'void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::WelfordOp'
    's<float, float, int, thrust::THRUST_200700_750_800_860_900_1000_1200_NS::pair<float, flo'
    'at> >, unsigned int, float, 2, 2> >(at::native::ReduceOp<float, at::native::WelfordOps<f'
    'loat, float, int, thrust::THRUST_200700_750_800_860_900_1000_1200_NS::pair<float, float>'
    ' >, unsigned int, float, 2, 2>)': 'norm',
    'void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl(at::Ten'
    'sorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() const::{lambda()#2}:'
    ':operator()() const::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::GeluCU'
    'DAKernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1}::operator()() '
    'const::{lambda()#2}::operator()() const::{lambda(float)#1}, std::array<char*, 2ul>)': 'pointwise',
    'nvjet_tst_64x8_64x16_4x1_v_bz_NNT': 'linear',
    'void gemmSN_NN_kernel<float, 256, 4, 2, 8, 2, 4, false, cublasGemvTensorStridedBatched<f'
    'loat const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched'
    '<float> >(cublasGemmSmallNParams<cublasGemvTensorStridedBatched<float const>, cublasGemv'
    'TensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float>)': 'linear',
    'void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Ten'
    'sorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::{'
    'lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned int>, T'
    'rivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, at::native'
    '::memory::StoreWithCast<1> >(int, at::native::direct_copy_kernel_cuda(at::TensorIterator'
    'Base&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::{lambda(floa'
    't)#1}, std::array<char*, 2ul>, TrivialOffsetCalculator<1, unsigned int>, TrivialOffsetCa'
    'lculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, at::native::memory::Stor'
    'eWithCast<1>)': 'pointwise',
    '(anonymous namespace)::stats_reduce_kernel(float const*, float*, int, int, int)': 'conv',
    'void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, float, false, float'
    ', float, float, true, false, false, false>(cublasLt::cublasSplitKParams<float>, float co'
    'nst*, float const*, float*, float*, float const*, float const*, float const*, float cons'
    't*, float*, void*, long, float*, int*, float*, float*, float const*, float const*, float'
    ' const*, float const*, float const*)': 'linear',
    'Memcpy DtoD (Device -> Device)': 'other',
    'void (anonymous namespace)::temporal_attention_kernel<float, 16>((anonymous namespace)::'
    'Params)': 'attention',
    'void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 2, 2, false, false'
    ', cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorS'
    'tridedBatched<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvPa'
    'ramsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<'
    'float const>, cublasGemvTensorStridedBatched<float>, float>, float, float)': 'linear',
    'void (anonymous namespace)::gn_kernel<float, 4>((anonymous namespace)::Params)': 'norm',
    'void (anonymous namespace)::splitk_epilogue_kernel<float>((anonymous namespace)::Conv<fl'
    'oat>, int)': 'conv',
    'void (anonymous namespace)::softmax_warp_forward<float, float, float, 10, false, false>('
    'float*, float const*, int, int, int, bool const*, int, bool)': 'attention',
    'void at::native::(anonymous namespace)::cunn_SoftMaxForwardReg<float, float, float, at::'
    'native::(anonymous namespace)::SoftMaxForwardEpilogue, long, 3>(float*, float const*, lo'
    'ng)': 'attention',
    'Memset (Device)': 'other',
    'void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<at::nativ'
    'e::index_kernel_impl<at::native::OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<'
    'long>, c10::ArrayRef<long>)::{lambda(char*, char const*, long)#1}>(at::TensorIteratorBas'
    'e&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::native::index_kernel_impl<at::native::'
    'OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>)::{lam'
    'bda(char*, char const*, long)#1} const&, bool)::{lambda(int)#1}>(long, at::native::gpu_i'
    'ndex_kernel<at::native::index_kernel_impl<at::native::OpaqueType<4> >(at::TensorIterator'
    'Base&, c10::ArrayRef<long>, c10::ArrayRef<long>)::{lambda(char*, char const*, long)#1}>('
    'at::TensorIteratorBase&, c10::ArrayRef<long>, c10::ArrayRef<long>, at::native::index_ker'
    'nel_impl<at::native::OpaqueType<4> >(at::TensorIteratorBase&, c10::ArrayRef<long>, c10::'
    'ArrayRef<long>)::{lambda(char*, char const*, long)#1} const&, bool)::{lambda(int)#1})': 'embed',
    'void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*, int, long, long'
    ', long, long, bool)': 'embed',
    'void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda('
    'at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, at::native::b'
    'float16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, '
    '2ul>)': 'pointwise',
    'std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, float, float, flo'
    'at, float, false, true, false, false, 9, false, cublasGemvParamsEx<int, cublasGemvTensor'
    'StridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTens'
    'orStridedBatched<float>, float> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched'
    '<float const>, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatch'
    'ed<float>, float>)': 'linear',
}


@pytest.mark.parametrize("name,category", list(CARD_KERNELS.items()),
                         ids=[n[:60] for n in CARD_KERNELS])
def test_kernel_category_table(name, category):
    assert profiler_analysis.kernel_category(name) == category


def _fake_profile(events, host=()):
    """A profile's events: device ``(name, start, end, is_range, kind)`` with
    correlation ids 1, 2, ... in order, and host ``(name, start, end,
    is_range, id)``: ranges and runtime launch calls; times in us.  Both of
    the profiler's views of them: ``events()`` (``FunctionEvent``s) and its
    kineto results (accessors, times in ns)."""
    dt = torch.autograd.DeviceType
    dev = [SimpleNamespace(name=n, device_type=dt.CUDA, is_user_annotation=ann,
                           activity_type=kind, id=i + 1,
                           time_range=SimpleNamespace(start=s, end=t))
           for i, (n, s, t, ann, kind) in enumerate(events)]
    cpu = [SimpleNamespace(name=n, device_type=dt.CPU, is_user_annotation=ann, id=i,
                           time_range=SimpleNamespace(start=s, end=t))
           for n, s, t, ann, i in host]

    def kineto(e):  # a build without activity types (torch 2.11) has no accessor
        kind = getattr(e, "activity_type", "cpu_op")
        return SimpleNamespace(
            name=lambda: e.name, device_type=lambda: e.device_type,
            is_user_annotation=lambda: e.is_user_annotation,
            start_ns=lambda: round(e.time_range.start * 1e3),
            end_ns=lambda: round(e.time_range.end * 1e3),
            **({} if kind is None else {"activity_type": lambda: kind}))

    results = SimpleNamespace(events=lambda: [kineto(e) for e in cpu + dev])
    return SimpleNamespace(events=lambda: cpu + dev,
                           profiler=SimpleNamespace(kineto_results=results))


def test_busy_idle_and_categories_of_a_profile():
    prof = _fake_profile([
        ("void conv2d_kernel<float, 128, 128>(Conv<float>)", 0.0, 1000.0, False, "kernel"),
        ("void fa_kernel<float, 64>(Params)", 500.0, 1500.0, False, "kernel"),  # overlaps
        ("temporal_attention_kernel(Params)", 2000.0, 2500.0, False, "kernel"),
        ("denoise", 0.0, 2500.0, True, "gpu_user_annotation"),  # a range: not work
        ("Memset (Device)", 3000.0, 3100.0, False, "gpu_memset"),
    ])
    b = profiler_analysis.busy(prof, window_ms=4.0)
    assert b["busy_ms"] == pytest.approx(2.1) and b["launches"] == 4
    assert b["idle_share"] == pytest.approx(1 - 2.1 / 4.0)
    cats = profiler_analysis.by_category(prof)
    assert cats["conv"] == pytest.approx(1.0) and cats["attention"] == pytest.approx(1.5)
    assert cats["attention_temporal"] == pytest.approx(0.5) and cats["other"] == pytest.approx(0.1)
    sh = profiler_analysis.shares(cats)
    assert sh["temporal_of_attention"] == pytest.approx(1 / 3)
    assert math.isclose(sum(sh[c] for c in profiler_analysis.CATEGORIES), 1.0)
    hist = profiler_analysis.op_histogram(prof)
    assert hist["void fa_kernel<float, 64>(Params)"] == {"ms": 1.0, "launches": 1.0}
    assert list(hist)[-1] == "Memset (Device)"


def test_busy_counts_every_device_event_but_ranges_where_events_carry_no_kind():
    prof = _fake_profile([("void fa_kernel<float, 64>(Params)", 0.0, 10.0, False, None),
                          ("denoise", 0.0, 40.0, True, None),
                          ("Memcpy DtoD (Device -> Device)", 20.0, 30.0, False, None)])
    b = profiler_analysis.busy(prof, window_ms=1.0)
    assert b["launches"] == 2 and b["busy_ms"] == pytest.approx(0.02)
    assert len(profiler_analysis.device_events(prof)) == 2
    assert list(profiler_analysis.op_histogram(prof)) == [
        "void fa_kernel<float, 64>(Params)", "Memcpy DtoD (Device -> Device)"]


def test_device_time_by_scope_follows_the_launch():
    """Each kernel goes to the ranges open when it was launched (its runtime
    call, by correlation id), outermost first; the rest to ``""``."""
    prof = _fake_profile(
        [("void conv2d_kernel<float, 128, 128>(Conv<float>)", 100.0, 400.0, False, "kernel"),
         ("void fa_kernel<float, 64>(Params)", 400.0, 500.0, False, "kernel"),
         ("sm80_xmma_gemm_f32f32", 500.0, 700.0, False, "kernel")],
        host=[("denoise", 0.0, 90.0, True, 0), ("down_0_1_attn", 10.0, 50.0, True, 0),
              ("cudaLaunchKernel", 5.0, 6.0, False, 1),
              ("cudaLaunchKernelExC", 20.0, 21.0, False, 2),
              ("cudaLaunchKernel", 95.0, 96.0, False, 3)])
    assert profiler_analysis.by_scope(prof) == pytest.approx(
        {"denoise": 0.3, "denoise/down_0_1_attn": 0.1, "": 0.2})
    assert profiler_analysis.by_scope(prof, depth=1) == pytest.approx(
        {"denoise": 0.4, "": 0.2})


def test_work_launched_in_an_moe_dispatch_scope_is_dispatch():
    """A softmax, a scatter and a cat launched inside an MoE layer's
    ``moe_dispatch`` range count as ``dispatch``, whatever their names; the
    expert GEMM between the two ranges stays ``linear``, and a pass with no
    such range keeps ``dispatch`` at 0."""
    prof = _fake_profile(
        [("void cunn_SoftMaxForward<float>", 100.0, 200.0, False, "kernel"),
         ("void index_put_kernel<float>", 200.0, 300.0, False, "kernel"),
         ("sm90_xmma_gemm_f32f32", 300.0, 700.0, False, "kernel"),
         ("CatArrayBatchedCopy<float>", 700.0, 750.0, False, "kernel")],
        host=[("layer_g1_0_moe", 0.0, 90.0, True, 0), ("moe_dispatch", 10.0, 30.0, True, 0),
              ("moe_dispatch", 60.0, 80.0, True, 0),
              ("cudaLaunchKernel", 11.0, 12.0, False, 1),
              ("cudaLaunchKernel", 20.0, 21.0, False, 2),
              ("cudaLaunchKernel", 40.0, 41.0, False, 3),
              ("cudaLaunchKernel", 70.0, 71.0, False, 4)])
    cats = profiler_analysis.by_category(prof)
    assert "dispatch" in profiler_analysis.CATEGORIES
    assert cats["dispatch"] == pytest.approx(0.25) and cats["linear"] == pytest.approx(0.4)
    assert cats["attention"] == cats["other"] == 0.0
    assert profiler_analysis.shares(cats)["dispatch"] == pytest.approx(0.25 / 0.65)
    assert profiler_analysis.by_scope(prof, depth=1) == pytest.approx({"layer_g1_0_moe": 0.65})
    plain = _fake_profile([("void cunn_SoftMaxForward<float>", 0.0, 100.0, False, "kernel")],
                          host=[("cudaLaunchKernel", 1.0, 2.0, False, 1)])
    cats = profiler_analysis.by_category(plain)
    assert cats["dispatch"] == 0.0 and cats["attention"] == pytest.approx(0.1)


def test_work_launched_in_a_scan_scope_is_scan():
    """What a Mamba-2 mixer launches under its ``mamba2_scan`` range (a
    GEMM, an exp, a cumsum) and an RG-LRU block under ``rglru_scan`` counts
    as ``scan``, whatever the names; the projections outside stay
    ``linear``; a ``_dispatch`` range inside a ``_scan`` one would give the
    innermost its category; a pass with no such range keeps ``scan`` at 0."""
    prof = _fake_profile(
        [("sm90_xmma_gemm_f32f32", 0.0, 300.0, False, "kernel"),
         ("sm90_xmma_gemm_f32f32", 300.0, 500.0, False, "kernel"),
         ("void vectorized_elementwise_kernel<exp>", 500.0, 600.0, False, "kernel"),
         ("void scan_innermost_dim<float>", 600.0, 650.0, False, "kernel"),
         ("void vectorized_elementwise_kernel<add>", 650.0, 700.0, False, "kernel"),
         ("sm90_xmma_gemm_f32f32", 700.0, 900.0, False, "kernel"),
         ("void index_put_kernel<float>", 900.0, 1000.0, False, "kernel")],
        host=[("layer_g0_0_mamba2", 0.0, 80.0, True, 0), ("mamba2_scan", 10.0, 40.0, True, 0),
              ("layer_g1_0_rglru", 80.0, 120.0, True, 0), ("rglru_scan", 90.0, 110.0, True, 0),
              ("moe_dispatch", 100.0, 105.0, True, 0),
              ("cudaLaunchKernel", 5.0, 6.0, False, 1),
              ("cudaLaunchKernel", 11.0, 12.0, False, 2),
              ("cudaLaunchKernel", 20.0, 21.0, False, 3),
              ("cudaLaunchKernel", 30.0, 31.0, False, 4),
              ("cudaLaunchKernel", 95.0, 96.0, False, 5),
              ("cudaLaunchKernel", 115.0, 116.0, False, 6),
              ("cudaLaunchKernel", 101.0, 102.0, False, 7)])
    cats = profiler_analysis.by_category(prof)
    assert "scan" in profiler_analysis.CATEGORIES
    assert cats["scan"] == pytest.approx(0.4) and cats["linear"] == pytest.approx(0.5)
    assert cats["dispatch"] == pytest.approx(0.1) and cats["pointwise"] == 0.0
    assert profiler_analysis.shares(cats)["scan"] == pytest.approx(0.4)
    assert profiler_analysis.by_scope(prof, depth=1) == pytest.approx(
        {"layer_g0_0_mamba2": 0.65, "layer_g1_0_rglru": 0.35})
    plain = _fake_profile([("void scan_innermost_dim<float>", 0.0, 100.0, False, "kernel")],
                          host=[("cudaLaunchKernel", 1.0, 2.0, False, 1)])
    assert profiler_analysis.by_category(plain)["scan"] == 0.0
