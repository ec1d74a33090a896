#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path (DefectGAN-256 with the AdaIN decoder, bf16,
batches of 8) through ``DefectGanSteps.generate`` at full width, with
random weights from a seed, and shows that it ran through the hand-written
CUDA kernel. Phases, each of which raises on failure:

  1. device   card name, count, torch/CUDA versions, nvidia-smi name + power
  2. build    nvcc builds the kernel from the checkout (-Xptxas -v lines)
  3. kernel   the kernel against its plain PyTorch version at the decoder's
              shapes, float32 and bfloat16, every activation
  4. serving  a small f32 input against the port on the CPU, then
              2 warm-up + 5 timed requests; 8 kernel launches per forward;
              the same batch with use_pallas=False (the plain version)
              agrees within a stated bf16 band
     profile  torch.profiler breakdown of a serving forward's kernels
  5. timing   kernel, plain version and one PyTorch call (F.instance_norm
              over (1, N*C, H, W) with per-(n, c) affine) at each decoder
              shape, beside the memory bound

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the
# tensor cores (the kernel's math runs there, in f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
FLOPS_PER_ELEMENT = 5  # pass 1: add + fma; pass 2: fma (+ act)

SEED = 0
BATCH = 8
# decoder call sites of the modulated instance norm at 256^2, batch 8:
# (N, C, H, W) -> calls per forward
SLICE_SHAPES = {(8, 256, 64, 64): 6, (8, 256, 128, 128): 1, (8, 128, 256, 256): 1}
# kernel vs plain: f32 within the JAX suite's 2e-5; bf16 y within atol 3e-2 +
# rtol 1.6e-2 (one bf16 ulp at |y| < 16: the two round the same f32 value,
# up to the last bit of a sum taken in another order); mean/inv are f32
F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 3e-2, 1.6e-2
# end to end, kernel path vs plain path, bf16: 4 bf16 ulps at magnitude 1
OUT_BAND = 3.2e-2
MEAN_BAND = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def make_norm_inputs(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dtype)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    return x, g, b


def phase_kernel_vs_plain(nk, fused, smi):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(s, dt, None) for s in SLICE_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [((8, 256, 64, 64), dt, act) for dt in (torch.float32, torch.bfloat16)
              for act in ("relu", "leaky_relu")]
    cases += [((3, 5, 7, 9), torch.bfloat16, "leaky_relu"),  # scalar path
              ((3, 5, 7, 9), torch.float32, None)]
    worst = 0.0
    for i, (shape, dt, act) in enumerate(cases):
        x, g, b = make_norm_inputs(shape, dt, SEED + i)
        y, mean, inv = nk.modulated_instance_norm_fwd(x, g, b, act)
        torch.cuda.synchronize()
        ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
        check(y.dtype == dt and y.shape == x.shape, "kernel output dtype/shape")
        tol = (dict(atol=F32_TOL, rtol=F32_TOL) if dt == torch.float32
               else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
        torch.testing.assert_close(y.float(), ry.float(), **tol)
        torch.testing.assert_close(mean, rmean, atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(inv, rinv, atol=F32_TOL, rtol=F32_TOL)
        err = (y.float() - ry.float()).abs().max().item()
        worst = max(worst, err)
        print(f"kernel-vs-plain {tuple(shape)} {str(dt)[6:]} act={act}: "
              f"max|dy|={err:.3e} max|dmean|="
              f"{(mean - rmean).abs().max().item():.3e} max|dinv|="
              f"{(inv - rinv).abs().max().item():.3e} tol={tol} [{smi}]")
    return worst


def phase_reference(nk, smi):
    """The card's kernel path against the port on the CPU (which
    tests/test_torch_generator.py holds against the JAX package) on a small
    float32 input: forward tolerance 5e-4 (DESIGN.md section 7)."""
    from de_i2i_gan_torch.config import DefectGanConfig
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, style_norm_block_type="adain",
                          use_pallas=True)
    card, cpu = DefectGanSteps(cfg, device="cuda"), DefectGanSteps(cfg, device="cpu")
    init_weights(card, SEED)
    init_weights(cpu, SEED)
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    labels = torch.eye(4)[:2]
    before = nk.LAUNCHES
    out, prob = card.generate(x, labels)
    check(nk.LAUNCHES - before == 4, "small config did not launch the kernel 4 times")
    rout, rprob = cpu.generate(x, labels)
    torch.testing.assert_close(out.cpu(), rout, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(prob.cpu(), rprob, atol=5e-4, rtol=5e-4)
    print(f"reference: card kernel path vs CPU plain path, 32x32 f32: "
          f"max|dout|={(out.cpu() - rout).abs().max().item():.3e} "
          f"max|dprob|={(prob.cpu() - rprob).abs().max().item():.3e} tol 5e-4 "
          f"[{smi}]")


def phase_serving(nk, smi):
    from de_i2i_gan_torch.config import DefectGanConfig
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    cfg = DefectGanConfig(image_size=256, label_nc=6, ngf=64, ndf=64,
                          num_scales=2, num_res=6, hidden_nc=128,
                          style_norm_block_type="adain", use_pallas=True,
                          sean_alpha=None, compute_dtype="bfloat16")
    steps = DefectGanSteps(cfg, device="cuda")
    init_weights(steps, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = []
    for _ in range(7):
        data = torch.rand((BATCH, 256, 256, 3), generator=gen,
                          device="cuda") * 2 - 1
        idx = torch.randint(0, cfg.label_nc, (BATCH,), generator=gen,
                            device="cuda")
        requests.append((data, F.one_hot(idx, cfg.label_nc).float()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    nk.LAUNCHES = 0  # the main path's run starts here
    latencies = []
    outputs = []
    for i, (data, labels) in enumerate(requests):
        before = nk.LAUNCHES
        t0 = time.perf_counter()
        out, prob = steps.generate(data, labels)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        check(nk.LAUNCHES - before == 8,
              f"forward {i} launched the kernel {nk.LAUNCHES - before} times, "
              "expected 8")
        if i >= 2:
            latencies.append(dt_ms)
        outputs.append((out, prob))
    launches = nk.LAUNCHES  # the main path's run ends here
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    for out, prob in outputs:
        check(out.shape == (BATCH, 256, 256, 3) and prob.shape == (BATCH, 256, 256, 1),
              f"output shapes {tuple(out.shape)} {tuple(prob.shape)}")
        check(out.dtype == torch.bfloat16 and prob.dtype == torch.bfloat16,
              "outputs are not bf16")
        check(bool(torch.isfinite(out).all() and torch.isfinite(prob).all()),
              "non-finite output")
        check(bool((prob >= 0).all() and (prob <= 1).all()), "prob outside [0, 1]")
        check(out.abs().max().item() <= 1.01, "out outside [-1, 1]")
    mean_ms = sum(latencies) / len(latencies)
    print(f"serving DefectGAN-256 adain bf16 batch {BATCH}: latency ms "
          f"{[round(v, 3) for v in latencies]} mean {mean_ms:.3f} "
          f"({BATCH * 1e3 / mean_ms:.1f} img/s), peak memory "
          f"{peak_mb:.0f} MiB, kernel launches {launches} over "
          f"{len(requests)} forwards [{smi}]")

    # the same requests through the plain version (cfg.use_pallas=False)
    plain = DefectGanSteps(cfg.replace(use_pallas=False), device="cuda")
    plain.G.load_state_dict(steps.G.state_dict())
    plain.E.load_state_dict(steps.E.state_dict())
    plain_lat = []
    for i, (data, labels) in enumerate(requests):
        t0 = time.perf_counter()
        pout, pprob = plain.generate(data, labels)
        torch.cuda.synchronize()
        if i >= 2:
            plain_lat.append((time.perf_counter() - t0) * 1e3)
        out, prob = outputs[i]
        for a, b, name in ((out, pout, "out"), (prob, pprob, "prob")):
            d = (a.float() - b.float()).abs()
            check(d.max().item() <= OUT_BAND and d.mean().item() <= MEAN_BAND,
                  f"request {i} {name}: kernel vs plain max {d.max().item():.3e} "
                  f"mean {d.mean().item():.3e} outside the band "
                  f"(max {OUT_BAND}, mean {MEAN_BAND})")
        if i == 0:
            print(f"kernel path vs plain path, request 0: max|dout|="
                  f"{(out.float() - pout.float()).abs().max().item():.3e} "
                  f"max|dprob|={(prob.float() - pprob.float()).abs().max().item():.3e}"
                  f" band max {OUT_BAND} mean {MEAN_BAND}")
    check(nk.LAUNCHES == launches, "the use_pallas=False run launched the kernel")
    pmean = sum(plain_lat) / len(plain_lat)
    print(f"serving, plain version (use_pallas=False): latency ms "
          f"{[round(v, 3) for v in plain_lat]} mean {pmean:.3f} "
          f"({BATCH * 1e3 / pmean:.1f} img/s) [{smi}]")
    return launches, mean_ms, pmean, steps, requests[2]


def phase_profile(steps, request, serve_ms, smi):
    """Where a serving forward's device time goes: torch.profiler over two
    forwards, device kernels summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            steps.generate(*request)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 2e3
    if device_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile: {device_ms:.3f} ms of kernels per forward, "
          f"{sum(e.count for e in kernels) // 2} launches; busy share "
          f"{device_ms / serve_ms:.1%} of the {serve_ms:.3f} ms unprofiled "
          f"request [{smi}]")
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 2e3:8.3f} ms x{e.count // 2:<4d} "
              f"{e.key[:100]}")


def device_ms(fn, iters):
    """Device time per call: a sleep kernel holds the stream while the host
    queues every call, so the events time the device, not the enqueue."""
    fn(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(nk, fused, smi):
    rate = PEAK_BYTES_PER_S
    rows = []
    for shape, calls in SLICE_SHAPES.items():
        n, c, h, w = shape
        x, g, b = make_norm_inputs(shape, torch.bfloat16, SEED)
        io_bytes = 2 * x.numel() * x.element_size()
        # rotate through copies so the working set exceeds the 50 MB L2
        copies = max(2, math.ceil(256e6 / io_bytes))
        xs = [x.clone() for _ in range(copies)]
        w1 = (1.0 + g).reshape(-1).contiguous()
        b1 = b.reshape(-1).contiguous()
        iters = 4 * copies

        def kernel(i):
            nk.modulated_instance_norm_fwd(xs[i % copies], g, b)

        def plain(i):
            fused.modulated_instance_norm_ref(xs[i % copies], g, b)

        def library(i):
            F.instance_norm(xs[i % copies].view(1, n * c, h, w),
                            weight=w1, bias=b1, eps=1e-5)

        # the library call computes the same function
        lib = F.instance_norm(x.view(1, n * c, h, w), weight=w1, bias=b1,
                              eps=1e-5).view(shape)
        torch.testing.assert_close(lib.float(), fused.modulated_instance_norm_ref(
            x, g, b)[0].float(), atol=BF16_ATOL, rtol=BF16_RTOL)
        # plain, kernel, kernel, plain (and the library call between)
        p1 = device_ms(plain, iters)
        k1 = device_ms(kernel, iters)
        l1 = device_ms(library, iters)
        k2 = device_ms(kernel, iters)
        p2 = device_ms(plain, iters)
        nbytes = io_bytes + 4 * n * c * 4  # + gamma, beta in; mean, inv out
        t_bytes = nbytes / rate
        t_ops = FLOPS_PER_ELEMENT * x.numel() / PEAK_F32_FLOPS
        row = dict(calls=calls, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                   library_ms=l1, bound_ms=max(t_bytes, t_ops) * 1e3,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rows.append(row)
        print(f"timing {shape} bf16 x{calls}/forward: kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, F.instance_norm {l1:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({nbytes / 1e6:.1f} "
              f"MB at {rate / 1e12:.2f} TB/s), roofline share "
              f"{row['bound_ms'] / row['ms']:.1%}, {copies} rotating copies "
              f"[{smi}]")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from de_i2i_gan_torch.ops import fused
    from de_i2i_gan_torch.ops.cuda import norm_kernels as nk

    # 1. device
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name} x{count}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"nvidia-smi: {smi}")

    # 2. build
    info = nk.build()
    print(f"build: {info.seconds:.2f} s -> {info.path.name}")
    for line in info.log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")

    # 3. kernel against plain
    worst = phase_kernel_vs_plain(nk, fused, smi)

    # 4. a small input against the CPU reference, then serving (the main path)
    phase_reference(nk, smi)
    launches, serve_ms, plain_serve_ms, steps, request = phase_serving(nk, smi)
    phase_profile(steps, request, serve_ms, smi)

    # 5. kernel times
    rows = phase_timing(nk, fused, smi)

    def per_forward(key):
        return sum(r[key] * r["calls"] for r in rows)

    record = {"kernels": [{
        "name": "modulated_instance_norm_fwd",
        "route": "cuda",
        "source": "de_i2i_gan_torch/csrc/modulated_instance_norm.cu",
        "replaces": "de_i2i_gan_tpu/ops/pallas/norm_kernels.py:51",
        "launches": launches,
        "max_abs_err": worst,
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": per_forward("library_ms"),
    }]}
    print(f"per forward (8 calls): kernel {record['kernels'][0]['ms']:.4f} ms, "
          f"plain {record['kernels'][0]['plain_ms']:.4f} ms, F.instance_norm "
          f"{record['kernels'][0]['library_ms']:.4f} ms, bound "
          f"{record['kernels'][0]['bound_ms']:.4f} ms; serving {serve_ms:.3f} ms "
          f"(plain path {plain_serve_ms:.3f} ms) [{smi}]")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
