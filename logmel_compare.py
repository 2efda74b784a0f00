#!/usr/bin/env python3
"""Times the fused log-Mel CUDA kernel beside another checkout's, in one run.

Run from the repository root on a machine with an NVIDIA H100 (sm_90a):

    git archive <commit> | tar -x -C scratch/parent   # scratch/ is ignored
    python3 logmel_compare.py scratch/parent

Both kernels are built from their own sources (each checkout's
``lidbox_tpu_torch/csrc/logmel.cu`` into its own ``_build/``) and run on the
same signals at the main paths' shapes: [32, 64000] (served 3 s wavs in the
4 s bucket), [32, 48000] (training), [32, 32000] (2 s chunks), [64, 32000]
over 20-7000 Hz (the pipeline and the CLI) and [1, 32000] (a streaming
chunk), in "highest" and "bf16". Each shape is timed in the order other,
this, this, other, three ways: back to back on CUDA events (the wrapper's
host time included, as ``chip_smoke.py`` times it), as a CUDA graph of 20
launches, and as device time under torch.profiler. The two outputs are
held to each other and to the plain version. Prints the card's name and
power limit and a table; ``--json PATH`` also writes the table there.

    python3 logmel_compare.py --phases

instead builds a copy of this checkout's kernel with ``clock64`` stamps
around each 32-row chunk of the first group of bin passes (in warp 0 of
every consumer warpgroup: the wait for the ring stage, then for each half
of the chunk the issue of its ``wgmma``s, the wait for them and the load
and split of the next A fragments) and prints the mean clocks of each
phase at [32, 64000] in both modes: where a consumer's time goes.
"""
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

SHAPES = [(32, 64000, {}), (32, 48000, {}), (32, 32000, {}),
          (64, 32000, {"fmin": 20.0, "fmax": 7000.0}), (1, 32000, {})]


def load_other(root):
    """The other checkout's ``ops/logmel.py`` as a module of its own: its
    sources and build directory are the checkout's, its feature helpers
    this package's."""
    path = os.path.join(root, "lidbox_tpu_torch", "ops", "logmel.py")
    spec = importlib.util.spec_from_file_location("other_logmel", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def times(logmel, x, kw):
    """(events ms, CUDA graph ms, device ms of the log-Mel kernels under
    torch.profiler, taken after the other two)."""
    run = lambda: logmel.fused_logmel(x, cs.RATE, **kw)
    events, graph = cs.cuda_ms(run), cs.graph_ms(run)
    run()
    torch.cuda.synchronize()
    ops = cs.device_ops(run, calls=10)
    return events, graph, sum(ms for ms, name in ops if "logmel" in name)


# --phases: a chunk's stamps (slots of 8), and the phases between them: the
# wait for the ring stage, then for each part of the chunk ("highest" loads
# a chunk in two halves, "bf16" in one) its wgmma issue, the wait for those
# wgmmas, and the load and split of the next part's A fragments
STAMP_SLOTS = 8


def _stamp(slot):
    return ("if (lane == 0 && warp == 0 && pass == pass0) "
            "reinterpret_cast<long long*>(p.partial)[((size_t)blockIdx.x * "
            f"2 + cw) * 128 + ({slot})] = clock64();\n")


def phases(logmel):
    """Per-chunk phase clocks of the first pass group at [32, 64000]."""
    src = open(logmel.SOURCE).read()
    n8 = f"c * {STAMP_SLOTS}"
    edits = [
        ("      mbar_wait(&full[s], ph);\n#pragma unroll\n",
         _stamp(n8) + "      mbar_wait(&full[s], ph);\n"
         + _stamp(n8 + " + 1") + "#pragma unroll\n"),
        ("        issue(f, c > 0 || h > 0, h);\n",
         "        issue(f, c > 0 || h > 0, h);\n"
         + _stamp(n8 + " + 2 + 3 * h")),
        ("        wgmma_wait<0>();\n        f.fence();\n",
         "        wgmma_wait<0>();\n" + _stamp(n8 + " + 3 + 3 * h")
         + "        f.fence();\n"),
        ("            f.load(row0, row1, kt0 + (c + 1) * kChunkInts);\n"
         "        }\n",
         "            f.load(row0, row1, kt0 + (c + 1) * kChunkInts);\n"
         "        }\n" + _stamp(n8 + " + 4 + 3 * h")),
    ]
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"--phases: the kernel no longer has {anchor!r}")
        src = src.replace(anchor, text)
    work = tempfile.mkdtemp()
    cu, so = os.path.join(work, "probe.cu"), os.path.join(work, "probe.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([logmel._find_nvcc(), *logmel.NVCC_FLAGS, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.lidbox_logmel.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    max_smem = logmel.device_limits(torch.device("cuda", 0))[1]
    if lib.lidbox_logmel_setup(max_smem):
        raise RuntimeError("probe library: lidbox_logmel_setup failed")
    B, T = 32, 64000
    x = torch.as_tensor(cs.noisy_sines(np.random.default_rng(cs.SEED + 11),
                                       B, T / cs.RATE, cs.RATE), device="cuda")
    for precision in ("highest", "bf16"):
        key = logmel._key(cs.RATE, 400, 512, 64, 0.0, 8000.0, precision)
        W, M, plan, geo = logmel._launch_config(key, B, T, 160,
                                                x.device)[:4]
        n = plan["nchunks"]
        if plan["splits"] != 1 or plan["nwg"] != 2 or n * STAMP_SLOTS > 128:
            raise RuntimeError(f"--phases expects one unsplit launch: {plan}")
        blocks = -(-plan["total_tiles"] // plan["nwg"])
        stamps = torch.zeros(blocks * 2 * 128, dtype=torch.int64,
                             device="cuda")
        out = torch.empty(B, plan["F"], 64, device="cuda")
        for _ in range(3):
            err = lib.lidbox_logmel(
                x.data_ptr(), W.data_ptr(), M.data_ptr(), out.data_ptr(),
                stamps.data_ptr(), geo, int(key[-1]), max_smem, None,
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"probe launch failed: {err}")
        parts = 1 if key[-1] else 2
        d = stamps.view(blocks, 2, 128)[:, :, :n * STAMP_SLOTS].cpu().numpy()
        d = d.astype(np.float64).reshape(blocks, 2, n, STAMP_SLOTS)
        names, spans = ["ring wait"], [d[..., 1] - d[..., 0]]
        prev = d[..., 1]
        for h in range(parts):
            for k, name in enumerate(("issue", "wgmma wait", "A load")):
                names.append(f"{name} {h}")
                spans.append(d[..., 2 + 3 * h + k] - prev)
                prev = d[..., 2 + 3 * h + k]
        spans = np.stack(spans, axis=-1)[:, :, 1:-1]  # steady chunks
        mean = spans.mean(axis=(0, 1, 2))
        print(f"phases {precision}, [{B}, {T}], clocks a chunk of the first "
              f"pass group (chunks 1-{n - 2}, {blocks} blocks x 2 consumers): "
              + ", ".join(f"{k} {v:.0f}" for k, v in zip(names, mean))
              + f"; {mean.sum():.0f} in all")
    return 0


def main(argv):
    if not torch.cuda.is_available():
        print("logmel_compare: no CUDA device", file=sys.stderr)
        return 1
    if argv == ["--phases"]:
        from lidbox_tpu_torch.ops import logmel
        print(f"card: {cs.card_line()}")
        return phases(logmel)
    json_path = None
    if len(argv) == 3 and argv[1] == "--json":
        argv, json_path = argv[:1], argv[2]
    if len(argv) != 1 or not os.path.isdir(argv[0]):
        print("usage: logmel_compare.py OTHER_CHECKOUT [--json PATH] | "
              "--phases", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from lidbox_tpu_torch.ops import logmel
    other = load_other(argv[0])
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, module in (("this", logmel), ("other", other)):
        module.build()
        for precision in ("highest", "bf16"):
            print(f"{name} kernel {precision}: "
                  f"{module.kernel_variant(precision)}")
    rng = np.random.default_rng(cs.SEED + 10)
    rows = []
    with torch.inference_mode():
        for B, T, mel_kw in SHAPES:
            x = torch.as_tensor(cs.noisy_sines(rng, B, T / cs.RATE, cs.RATE),
                                device="cuda")
            for precision in ("highest", "bf16"):
                kw = dict(cs.KERNEL_KW, precision=precision, **mel_kw)
                ours = logmel.fused_logmel(x, cs.RATE, **kw)
                theirs = other.fused_logmel(x, cs.RATE, **kw)
                plain = logmel.logmel_plain(x, cs.RATE, **kw)
                runs = [times(m, x, kw) for m in (other, logmel, logmel, other)]
                t_other = np.mean([runs[0], runs[3]], axis=0)
                t_this = np.mean([runs[1], runs[2]], axis=0)
                bound_ms, _ = cs.logmel_bound(logmel, B, T, cs.RATE, precision,
                                              kw)
                row = {
                    "shape": [B, T], "precision": precision,
                    "mel_hz": [mel_kw.get("fmin", 0.0),
                               mel_kw.get("fmax", 8000.0)],
                    "other_ms": dict(zip(("events", "graph", "device"),
                                         t_other.tolist())),
                    "this_ms": dict(zip(("events", "graph", "device"),
                                        t_this.tolist())),
                    "bound_ms": bound_ms,
                    "this_vs_other_max_abs": (ours - theirs).abs().max().item(),
                    "this_vs_plain_max_abs": (ours - plain).abs().max().item(),
                }
                rows.append(row)
                print(f"[{B}, {T}] {precision} {row['mel_hz']} Hz: "
                      f"other {t_other[0]:.4f} / {t_other[1]:.4f} / "
                      f"{t_other[2]:.4f} ms, this {t_this[0]:.4f} / "
                      f"{t_this[1]:.4f} / {t_this[2]:.4f} ms (events / graph "
                      f"/ device), speed-up on device "
                      f"{t_other[2] / t_this[2]:.2f}x; bound {bound_ms:.4f} ms "
                      f"({bound_ms / t_this[2]:.1%} of it); outputs "
                      f"{row['this_vs_other_max_abs']:.3e} apart")
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"card": card, "torch": torch.__version__,
                       "rows": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
