#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pydrobert_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without a card, or without the package beside it,
it exits non-zero before printing any result. Phases, one JSON line each:

1. environment: the card, torch/CUDA versions, the kernels' build time;
2. kernels vs their plain PyTorch versions on the card: the decode prologue
   and the top-M at the headline shape and edge cases, bit-exact top
   values and indices, exact max and blank, ``sm_den`` within rtol 2e-6;
3. the main path: a seeded d512/L8/H8/V1024 ConformerCTC (bf16) serves
   three requests of 32 utterances through ``ctc_recognizer(width=16)``;
   the decode-prologue kernel must have been launched by them, the card's
   hypotheses for four utterances must match a CPU decode of the same
   logits, and the model on the card must match itself on the CPU;
4. times (medians of 7 after warm-up): each kernel's own device time from
   a torch.profiler trace, beside its wrapper's, its plain version's and
   ``torch.topk``'s per call from CUDA events around 20 queued calls, and
   its bound; wall times of the encoder, the decode and a whole request,
   taken in turn so they share the host's load; peak memory.

``python3 chip_smoke.py --profile`` runs phase 1, then traces one served
request and one decode alone with ``torch.profiler``: wall time, device
busy time and idle share, kernel launches per decode frame, and the
kernels that take the most device time.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``. Any failed check raises.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
T_RAW, N_BATCH, N_REQUESTS, WIDTH = 2000, 32, 3, 16
HEADLINE = (500, 32, 1025)  # (T, N, V + 1) of the decode at this batch
M_HEADLINE = 2 * WIDTH
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, outside the tensor cores
REPS = 7
INNER = 20  # calls queued between one pair of events


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS, inner=INNER, warmup=2):
    """Median milliseconds per call of ``fn()`` on the current stream:
    ``inner`` calls queued back to back between one pair of CUDA events, so
    the host's work for a call overlaps the device's work for the last."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_ms(fn, kernel=None, calls=INNER):
    """Device milliseconds per call of ``fn()`` from torch.profiler's CUDA
    trace: the kernels whose name holds ``kernel`` (each call must launch
    one), or every kernel when ``kernel`` is None. None when the trace
    holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    hits = [
        a for a in prof.key_averages()
        if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
        and (kernel is None or kernel in a.key)
    ]
    if not hits:
        return None
    launched = sum(a.count for a in hits)
    if kernel is not None and launched != calls:
        raise AssertionError(f"{calls} calls launched {kernel} {launched} times")
    return sum(a.self_device_time_total for a in hits) / 1e3 / calls


def host_ms(fns, reps=REPS, warmup=1):
    """Wall milliseconds of each of ``fns``, every call ending in a device
    synchronize. Each rep runs all of them in turn, so they see the same
    host load. Returns the medians and the runs."""
    for _ in range(warmup):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    runs = [[] for _ in fns]
    for _ in range(reps):
        for fn, times in zip(fns, runs):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return [statistics.median(t) for t in runs], runs


def same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def max_abs_err(pairs):
    err = 0.0
    for a, b in pairs:
        d = (a.float() - b.float()).abs()
        d = d[torch.isfinite(d)]
        if d.numel():
            err = max(err, float(d.max()))
    return err


def make_logits(shape, gen, kind, dtype):
    x = torch.randn(shape, generator=gen, device="cuda") * 3
    if kind == "ties":
        x = torch.round(x * 4) / 4
    elif kind == "inf":
        u = torch.rand(shape, generator=gen, device="cuda")
        x = torch.where(u < 0.02, float("inf"), x)
        x = torch.where(u > 0.95, float("-inf"), x)
    return x.to(dtype).contiguous()


def check_prologue(kernels, x, m, bias):
    got = kernels.decode_prologue(x, m, bias)
    exp = kernels.decode_prologue_reference(x, m, bias)
    vals_ok = torch.equal(got[0].view(torch.int32), exp[0].view(torch.int32))
    idx_ok = torch.equal(got[1], exp[1])
    mx_ok = same_or_both_nan(got[2], exp[2])
    blank_ok = same_or_both_nan(got[4], exp[4])
    den_err = ((got[3] - exp[3]).abs() / exp[3].abs())
    den_ok = bool(
        ((den_err <= 2e-6) | (torch.isnan(got[3]) & torch.isnan(exp[3]))
         | (got[3] == exp[3])).all()
    )
    gv, gi = kernels.top_m(x, m)
    ev, ei = kernels.top_m_reference(x, m)
    tm_ok = torch.equal(gv.view(torch.int32), ev.view(torch.int32)) and torch.equal(gi, ei)
    return {
        "prologue_ok": vals_ok and idx_ok and mx_ok and blank_ok and den_ok,
        "top_m_ok": tm_ok,
        "prologue_err": max_abs_err(zip(got, exp)),
        "top_m_err": max_abs_err([(gv, ev)]),
    }


def phase_kernels(kernels):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for with_bias in (False, True):
            cases.append(("headline", HEADLINE, M_HEADLINE, dtype, with_bias, "normal"))
    cases += [
        ("serving_b256", (500, 256, 1025), M_HEADLINE, torch.float32, False, "normal"),
        ("v1000", (500, 32, 1001), M_HEADLINE, torch.float32, True, "normal"),
        ("m1", HEADLINE, 1, torch.float32, False, "normal"),
        ("m_eq_v", (64, 8, 65), 64, torch.bfloat16, True, "normal"),
        ("ties", HEADLINE, M_HEADLINE, torch.float32, True, "ties"),
        ("ties_bf16", HEADLINE, M_HEADLINE, torch.bfloat16, False, "ties"),
        ("inf", HEADLINE, M_HEADLINE, torch.float32, False, "inf"),
    ]
    worst = {"decode_prologue": 0.0, "top_m": 0.0}
    for name, shape, m, dtype, with_bias, kind in cases:
        x = make_logits(shape, gen, kind, dtype)
        bias = (
            torch.randn(shape[-1] - 1, generator=gen, device="cuda")
            if with_bias else None
        )
        res = check_prologue(kernels, x, m, bias)
        torch.cuda.synchronize()
        emit({
            "phase": "kernels", "case": name, "shape": list(shape), "m": m,
            "dtype": str(dtype).replace("torch.", ""), "bias": with_bias, **res,
        })
        if not (res["prologue_ok"] and res["top_m_ok"]):
            raise AssertionError(f"kernel parity failed for case {name}: {res}")
        worst["decode_prologue"] = max(worst["decode_prologue"], res["prologue_err"])
        worst["top_m"] = max(worst["top_m"], res["top_m_err"])
    return worst


def phase_main_path(torch_pkg):
    ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, kernels = torch_pkg
    cfg, model = make_model(ConformerConfig, ConformerCTC)
    recognize = ctc_recognizer(model, width=WIDTH)
    requests = make_requests(cfg)

    captured = []
    hook = model.register_forward_hook(lambda mod, inp, out: captured.append(out))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outputs = [recognize(f, l) for f, l in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    hook.remove()
    if launches["decode_prologue"] != N_REQUESTS:
        raise AssertionError(f"decode_prologue launches {launches}, expected {N_REQUESTS}")

    S = -(-(-(-T_RAW // 2)) // 2)
    for (hyps, hlens, probs), (logits, out_lens) in zip(outputs, captured):
        assert hyps.shape == (N_BATCH, WIDTH, S) and hlens.shape == (N_BATCH, WIDTH)
        assert logits.shape == (N_BATCH, S, cfg.vocab_size + 1)
        assert bool(torch.isfinite(logits).all()), "non-finite logits"
        assert bool(((hyps >= 0) & (hyps < cfg.vocab_size)).all())
        assert bool((hlens <= out_lens[:, None]).all())
        assert bool(((probs >= 0) & (probs <= 1)).all()), "probabilities out of [0, 1]"
        assert bool((probs[:, :-1] >= probs[:, 1:]).all()), "beams out of order"

    # the card's hypotheses against a CPU decode of the same logits
    (hyps, hlens, probs), (logits, out_lens) = outputs[0], captured[0]
    k = 4
    cy, cl, cp = CTCPrefixSearch(WIDTH)(
        logits[:k].transpose(0, 1).contiguous().cpu(), out_lens[:k].cpu()
    )
    gh, gl, gp = hyps[:k].cpu(), hlens[:k].cpu(), probs[:k].cpu()
    if not torch.equal(cl, gl):
        raise AssertionError("y_lens differ between the card and the CPU")
    for n in range(k):
        for w in range(WIDTH):
            L = int(cl[n, w])
            if not torch.equal(cy[:L, n, w], gh[n, w, :L]):
                raise AssertionError(f"hypothesis ({n}, {w}) differs from the CPU's")
    live = cp > 0
    prob_err = float(((cp - gp).abs()[live] / cp[live]).max()) if live.any() else 0.0
    if not torch.allclose(gp, cp, rtol=1e-5, atol=0):
        raise AssertionError(f"y_probs differ from the CPU's (rel err {prob_err})")

    # the model on the card against itself on the CPU, float32, small input
    cfg32 = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8,
        dtype=torch.float32,
    )
    m_gpu = ConformerCTC(cfg32, device="cuda")
    m_gpu.load_state_dict(model.state_dict())
    m_cpu = ConformerCTC(cfg32, device="cpu")
    m_cpu.load_state_dict(model.state_dict())
    f_small, l_small = requests[0][0][:2, :400], torch.tensor([400, 271])
    lg_gpu = m_gpu(f_small, l_small)[0].cpu()
    lg_cpu = m_cpu(f_small.cpu(), l_small)[0]
    model_err = float((lg_gpu - lg_cpu).abs().max())
    if not model_err < 1e-2:
        raise AssertionError(f"f32 model on the card vs the CPU: max abs err {model_err}")

    emit({
        "phase": "main_path", "model": "ConformerCTC d512 L8 H8 V1024 bf16",
        "requests": N_REQUESTS, "batch": N_BATCH, "t_raw": T_RAW, "width": WIDTH,
        "launches": launches, "serve_s_first_pass": serve_s,
        "cpu_check_utts": k, "y_probs_max_rel_err": prob_err,
        "model_f32_card_vs_cpu_max_abs_err": model_err,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return model, recognize, requests, launches, captured[0]


def make_model(ConformerConfig, ConformerCTC):
    """The flagship ConformerCTC at full width, seeded."""
    cfg = ConformerConfig(
        vocab_size=1024, num_filts=80, d_model=512, num_layers=8, num_heads=8
    )
    model = ConformerCTC(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        # random weights give diffuse logits whose path masses crowd
        # together; a sharper head makes decisions like a trained model's
        model.ctc_head.weight.mul_(32.0)
    return cfg, model


def make_requests(cfg):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    requests = []
    for _ in range(N_REQUESTS):
        feats = torch.randn((N_BATCH, T_RAW, cfg.num_filts), generator=gen, device="cuda")
        lens = torch.randint(T_RAW // 2, T_RAW + 1, (N_BATCH,), generator=gen, device="cuda")
        requests.append((feats, lens))
    return requests


def trace(fn):
    """Wall ms, device-busy ms, kernel launches and the top kernels of one
    ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [
        a for a in prof.key_averages()
        if a.device_type == DeviceType.CUDA and a.self_device_time_total > 0
    ]
    busy_ms = sum(a.self_device_time_total for a in kern) / 1e3
    kern.sort(key=lambda a: -a.self_device_time_total)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": sum(a.count for a in kern),
        "top_kernels": [
            [a.key[:80], a.self_device_time_total / 1e3, a.count] for a in kern[:8]
        ],
    }


def phase_profile(ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch):
    cfg, model = make_model(ConformerConfig, ConformerCTC)
    recognize = ctc_recognizer(model, width=WIDTH)
    feats, lens = make_requests(cfg)[0]
    logits, out_lens = model(feats, lens)
    x = logits.transpose(0, 1).contiguous()
    search = CTCPrefixSearch(WIDTH)
    served = trace(lambda: recognize(feats, lens))
    decode = trace(lambda: search(x, out_lens))
    decode["launches_per_frame"] = decode["kernel_launches"] / x.shape[0]
    encoder = trace(lambda: model(feats, lens))
    emit({"phase": "profile", "request": served, "encoder": encoder, "decode": decode})


def prologue_bound_ms(T, N, Vp1, m, itemsize):
    rows = T * N
    bytes_ = rows * Vp1 * itemsize + rows * (2 * m * 4 + 3 * 4)
    ops = rows * Vp1 * 6  # max, subtract, exp, add, key, compare per lane
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3, (
        "bytes" if bytes_ / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations"
    )


def topm_bound_ms(rows, V, m, itemsize):
    bytes_ = rows * V * itemsize + rows * 2 * m * 4
    ops = rows * V * 2  # key, compare per lane
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def phase_times(kernels, model, recognize, requests, CTCPrefixSearch, logits):
    T, N, Vp1 = HEADLINE
    V, m = Vp1 - 1, M_HEADLINE
    x = logits.transpose(0, 1).contiguous()  # the main path's (T, N, V + 1)
    assert tuple(x.shape) == HEADLINE
    xv = x[..., :V].contiguous()  # what hoisted_top_k would be handed
    fns = {
        "decode_prologue": (
            lambda: kernels.decode_prologue(x, m),
            lambda: kernels.decode_prologue_reference(x, m),
            lambda: torch.topk(x[..., :V], m),
        ),
        "top_m": (
            lambda: kernels.top_m(xv, m),
            lambda: kernels.top_m_reference(xv, m),
            lambda: torch.topk(xv, m),
        ),
    }
    bounds = {
        "decode_prologue": prologue_bound_ms(T, N, Vp1, m, 4),
        "top_m": topm_bound_ms(T * N, V, m, 4),
    }
    times, line = {}, {"phase": "times", "shape": list(HEADLINE), "m": m}
    for name, (kernel, plain, library) in fns.items():
        wrapper = cuda_ms(kernel)
        own = device_ms(kernel, "prologue_kernel")
        times[name] = {
            # the kernel's own device time; the events' time where the
            # profiler saw none
            "ms": wrapper if own is None else own,
            "ms_from": "cuda_events" if own is None else "profiler",
            "wrapper_ms": wrapper,
            "plain_ms": cuda_ms(plain),
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": cuda_ms(library),
        }
        line[name] = dict(
            times[name],
            plain_device_ms=device_ms(plain),
            library_device_ms=device_ms(library),
        )

    feats, lens = requests[0]
    search = CTCPrefixSearch(WIDTH)
    out_lens = (((lens + 1) // 2) + 1) // 2
    (enc_ms, dec_ms, req_ms), runs = host_ms([
        lambda: model(feats, lens),
        lambda: search(x, out_lens),
        lambda: recognize(feats, lens),
    ])
    emit(dict(
        line,
        encoder_ms_per_batch=enc_ms, decode_ms_per_batch=dec_ms,
        request_ms=req_ms, utt_per_s=N_BATCH / (req_ms / 1e3),
        encoder_share_of_request=enc_ms / req_ms,
        decode_share_of_request=dec_ms / req_ms,
        request_minus_parts_ms=req_ms - enc_ms - dec_ms,
        runs_ms={"encoder": runs[0], "decode": runs[1], "request": runs[2]},
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
    ))
    return times


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    try:
        from pydrobert_tpu_torch.export import ctc_recognizer
        from pydrobert_tpu_torch.models import ConformerConfig, ConformerCTC
        from pydrobert_tpu_torch.ops import _build, kernels
        from pydrobert_tpu_torch.ops.decoding import CTCPrefixSearch
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    # stated, not assumed: no TF32 in float32 products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.build_log()
    emit({
        "phase": "env", "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "build_s": build_s,
        "nvcc_s": log["seconds"], "library": os.path.relpath(log["path"]),
        "ptxas": [
            l.strip() for l in (log["stderr"] or "").splitlines()
            if "registers" in l or "spill" in l
        ],
    })

    if "--profile" in argv:
        phase_profile(ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch)
        print(smi, flush=True)
        emit(ok_line())
        return 0

    errs = phase_kernels(kernels)
    model, recognize, requests, launches, (logits, _) = phase_main_path(
        (ConformerConfig, ConformerCTC, ctc_recognizer, CTCPrefixSearch, kernels)
    )
    times = phase_times(kernels, model, recognize, requests, CTCPrefixSearch, logits)

    src = "pydrobert_tpu_torch/csrc/prologue.cu"
    replaces = {
        "decode_prologue": "pydrobert_tpu/ops/pallas.py:1664",
        "top_m": "pydrobert_tpu/ops/pallas.py:1359",
    }
    rows = []
    for name in ("decode_prologue", "top_m"):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces[name],
            "launches": launches[name], "on_main_path": name == "decode_prologue",
            "max_abs_err": errs[name], **times[name],
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit(ok_line())
    return 0


def ok_line():
    return {
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
