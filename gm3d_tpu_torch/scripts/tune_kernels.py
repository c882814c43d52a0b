"""The FPS and KNN kernels on the GPU: launch geometry, registers, ablations.

    python3 -m gm3d_tpu_torch.scripts.tune_kernels [--csrc DIR] [--csrc-only]

Builds ``fps.cu`` and ``knn.cu`` of a source directory on their own (with
``ptxas -v``), calls their C entry points directly and prints JSON lines
(ms of one launch: ten launches captured in a CUDA graph, the median of 20
replays by CUDA events over ten, so that the host's time to issue a launch,
longer than these kernels, does not count; the card's name and power limit on
every line):

  build     per kernel instantiation: registers, stack frame, spills
  fps       per shape: ms and ms a round at the wrapper's block size, the
            sweep over block sizes, indices equal to the plain version or not
  knn       per shape: ms and ns a query at the wrapper's geometry, the sweep
            over warps a block, queries a block, runs a lane and the cloud
            staged in shared memory (1) or read from L2 (0); the overflow
            count (queries that took the k-round selection) and the mean and
            largest candidate count C, from the plain emulation of the
            selection (``ops/knn.py::knn_select_emulated``)
  ablation  the same kernel with one part taken out, from patched copies of
            the sources built on their own; the answers of those runs are
            wrong by design and only their times mean something

``--csrc DIR`` adds another copy of the sources (the parent commit's, say,
from ``git archive`` unpacked under the git-ignored ``gm3d_tpu_torch/build/``):
both are built, and every shape is timed on the two in turns (other, this,
this, other) so that they meet on one card in one call. The script tells the
two designs apart by their C interfaces: the kernels before the redesign (one
block a cloud over shared memory; one warp a query with k rescans; those of
commit 99f5394, kept so that PERF.md's old-against-new tables can be run
again) and after (``redux.sync`` arg-max over registers; a threshold and a
candidate sort).

It needs a CUDA device and ``nvcc``; it measures and asserts nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from gm3d_tpu_torch.ops import _build
from gm3d_tpu_torch.scripts.profile_attention import _ms as _event_ms
from gm3d_tpu_torch.scripts.profile_pretrain import gpu_name_and_limit

# the modules (the package's ``fps`` and ``knn`` names are functions)
fps_mod = importlib.import_module("gm3d_tpu_torch.ops.fps")
knn_mod = importlib.import_module("gm3d_tpu_torch.ops.knn")

FPS_SHAPES = ((128, 1024, 64), (256, 1024, 64), (32, 8192, 1024), (32, 8192, 1200),
              (32, 2048, 512), (32, 10000, 1024))
KNN_SHAPES = ((128, 1024, 64, 32), (256, 1024, 64, 32), (32, 2048, 512, 16),
              (32, 4096, 64, 32), (32, 6144, 64, 32), (32, 7136, 64, 32), (32, 8192, 64, 32))
FPS_ABLATION_SHAPES = ((128, 1024, 64), (32, 8192, 1024))
KNN_ABLATION_SHAPES = ((128, 1024, 64, 32), (32, 2048, 512, 16))

# A patch is (file, text found exactly once, what replaces it).
# The kernels before the redesign:
_OLD_FPS_CLAMP = ("fps.cu", "        last = w.i;", "        last = min(max(w.i, 0), N - 1);")
OLD_ABLATIONS = {
    "fps": {
        "arg-max chain alone (point update taken out)": [
            ("fps.cu", "        for (int i = tid; i < N; i += T) {\n            const float dx",
             "        if (n < 0)\n        for (int i = tid; i < N; i += T) {\n"
             "            const float dx"), _OLD_FPS_CLAMP],
        "point update alone (arg-max chain and barrier taken out)": [
            ("fps.cu", "        c = warp_argmax(c);\n", ""),
            ("fps.cu", "        __syncthreads();\n        Cand w;", "        Cand w;"),
            ("fps.cu", "        w = warp_argmax(w);\n", ""), _OLD_FPS_CLAMP],
        "barrier taken out": [
            ("fps.cu", "        __syncthreads();\n        Cand w;", "        Cand w;"),
            _OLD_FPS_CLAMP],
    },
    "knn": {
        "rescans taken out": [
            ("knn.cu", "            for (int i = lane; i < N; i += 32) {\n"
                       "                const float d = row[i];",
             "            if (k < 0)\n            for (int i = lane; i < N; i += 32) {\n"
             "                const float d = row[i];")],
        "shuffle arg-min taken out (one shuffle from lane j)": [
            ("knn.cu", "        const Cand w = warp_argmin(mine);",
             "        Cand w;\n        w.v = __shfl_sync(0xffffffffu, mine.v, j & 31);\n"
             "        w.i = __shfl_sync(0xffffffffu, mine.i, j & 31);")],
        "distance phase alone": [
            ("knn.cu", "    int* oi = out_idx + ((size_t)b * G + g) * k;",
             "    if (k > 0) {\n        out_dist[((size_t)b * G + g) * k + lane % k] = mine.v;\n"
             "        return;\n    }\n    int* oi = out_idx + ((size_t)b * G + g) * k;")],
    },
}
# The kernels after the redesign:
NEW_ABLATIONS = {
    "fps": {
        "arg-max chain alone (the update of one point a thread)": [
            ("fps.cu", "        for (int p = 0; p < P; ++p) {\n            float px, py, pz;",
             "        for (int p = 0; p < (n < 0 ? P : 1); ++p) {\n"
             "            float px, py, pz;")],
        "point update alone (reductions and barrier taken out)": [
            ("fps.cu", "        int best = __reduce_max_sync(FULL, v);\n"
                       "        int last = (int)__reduce_min_sync(FULL, v == best ? "
                       "(unsigned)(t + T * bp) : FULL);\n        if (W > 1) {",
             "        int best = v;\n        int last = min(t + T * bp, N - 1);\n"
             "        if (W < 0) {")],
        "barrier taken out": [
            ("fps.cu", "            __syncthreads();\n            const int2 e",
             "            const int2 e"),
            ("fps.cu", "        w = lds_v4(cloud + 16 * last);",
             "        w = lds_v4(cloud + 16 * min(max(last, 0), N - 1));")],
    },
    "knn": {
        "distances, keys and run minima alone": [
            ("knn.cu", "        // the candidates: every point at or below tau\n",
             "        if (k > 0) {\n            od[lane % k] = __uint_as_float(run[0] ^ run[R - 1]);"
             "\n            continue;\n        }\n")],
        "candidate sort taken out (written unsorted)": [
            ("knn.cu", "    warp_sort<E>(c, lane);\n", "")],
    },
}


def _ms(launch, launches: int = 10) -> float:
    """Device time of one ``launch()`` in ms, from a CUDA graph of ``launches``."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            launch()
    return _event_ms(graph.replay) / launches


def _old_fps_threads(num_points: int) -> int:
    """The launch geometry the wrapper gave the kernel before the redesign."""
    return min(512, max(32, -(-(-(-num_points // 4)) // 32) * 32))


def _old_knn_warps(num_ref: int, num_query: int) -> int:
    warps = max(1, min(4, num_query))
    while warps > 1 and warps * num_ref * 4 > 64 * 1024:
        warps //= 2
    return warps


class Kernels:
    """``fps.cu`` and ``knn.cu`` of one source directory, each built on its
    own into a library, with optional patches; ``new[name]`` tells the
    designs apart."""

    def __init__(self, csrc: Path, out: Path, patches=()):
        shutil.copytree(csrc, out)
        for file, find, replace in patches:
            text = (out / file).read_text()
            if text.count(find) != 1:
                raise RuntimeError(f"{find!r} is not in {csrc / file} exactly once")
            (out / file).write_text(text.replace(find, replace))
        self.new = {"fps": "__reduce_max_sync" in (out / "fps.cu").read_text(),
                    "knn": "overflow" in (out / "knn.cu").read_text()}
        self.dir = out
        self.procs = {}
        for name in ("fps", "knn"):
            so = out / f"{name}.so"
            self.procs[name] = subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                 "-o", str(so), str(out / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.log = {}
        self.lib = {}

    def wait(self) -> "Kernels":
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, proc in self.procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.dir / name}.cu:\n{out}")
            self.log[name] = out
            lib = ctypes.CDLL(str(self.dir / f"{name}.so"))
            fn = getattr(lib, "gm3d_" + name)
            if name == "fps":
                fn.argtypes = [p, p, i, i, i, i, p]
            else:
                fn.argtypes = ([p, p, p, p, p, i, i, i, i, i, i, i, i, p] if self.new[name]
                               else [p, p, p, p, i, i, i, i, i, p])
            fn.restype = i
            self.lib[name] = fn
        return self

    def ptxas(self) -> dict:
        """Registers, stack and spills of every entry function, by name."""
        report = {}
        for log in self.log.values():
            lines = log.splitlines()
            for n, line in enumerate(lines):
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if not m:
                    continue
                name = m.group(1)
                if shutil.which("c++filt"):
                    name = subprocess.run(["c++filt", name], capture_output=True,
                                          text=True).stdout.strip() or name
                info = " ".join(lines[n + 1:n + 4])
                regs = re.search(r"Used (\d+) registers", info)
                stack = re.search(r"(\d+) bytes stack frame", info)
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
                report[name] = {"registers": int(regs.group(1)) if regs else None,
                                "stack_bytes": int(stack.group(1)) if stack else None,
                                "spill_bytes": [int(spills.group(1)), int(spills.group(2))]
                                if spills else None}
        return report

    # -- launches --------------------------------------------------------

    def fps_default(self, batch: int, num_points: int):
        return ((fps_mod._block_threads(num_points) if self.new["fps"]
                 else _old_fps_threads(num_points)),)

    def fps_sweep(self, batch: int, num_points: int):
        if not self.new["fps"]:
            return [(t,) for t in (64, 128, 256, 512, 1024)]
        return [(t,) for t in (32, 64, 128, 256, 512, 1024)
                if fps_mod._geometry_fits(num_points, t)]

    def fps(self, xyz: torch.Tensor, n: int, geometry) -> torch.Tensor:
        batch, num_points, _ = xyz.shape
        out = torch.empty((batch, n), dtype=torch.int32, device=xyz.device)

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            _build.check_launch(self.lib["fps"](xyz.data_ptr(), out.data_ptr(), batch,
                                                num_points, n, *geometry, stream), "fps")
        return launch, out

    def knn_default(self, batch: int, num_ref: int, num_query: int, k: int):
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
        return (knn_mod._launch_geometry(batch, num_ref, num_query, k, sms) if self.new["knn"]
                else (_old_knn_warps(num_ref, num_query),))

    def knn_sweep(self, batch: int, num_ref: int, num_query: int, k: int):
        if not self.new["knn"]:
            return [(w,) for w in (1, 2, 4, 8, 16) if w * num_ref * 4 <= 227 * 1024]
        out = []
        for staged in (1, 0):
            most = knn_mod._max_warps(num_ref, bool(staged))
            for w in sorted({x for x in (2, 4, 8, 16, most) if 1 <= x <= most}):
                for per_warp in (1, 2, 4):
                    for runs in (2, 4):
                        q = w * per_warp
                        if q <= max(num_query, w):
                            out.append((w, q, runs, staged))
        return out

    def knn(self, ref: torch.Tensor, query: torch.Tensor, k: int, geometry):
        batch, num_ref, _ = ref.shape
        num_query = query.shape[1]
        idx = torch.empty((batch, num_query, k), dtype=torch.int32, device=ref.device)
        dist = torch.empty((batch, num_query, k), dtype=torch.float32, device=ref.device)
        overflow = torch.zeros(1, dtype=torch.int64, device=ref.device)

        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            args = [ref.data_ptr(), query.data_ptr(), idx.data_ptr(), dist.data_ptr()]
            if self.new["knn"]:
                args.append(overflow.data_ptr())
            _build.check_launch(self.lib["knn"](*args, batch, num_ref, num_query, k,
                                                *geometry, stream), "knn")
        return launch, (dist, idx, overflow)


def _try_ms(launch) -> float | None:
    """ms of a launch, or None where the C entry refuses the geometry."""
    try:
        launch()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return _ms(launch)


def fps_rows(versions: list[tuple[str, Kernels]], gpu: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, n, g in FPS_SHAPES:
        xyz = torch.randn(b, n, 3, device="cuda", generator=gen)
        want = fps_mod.fps_indices_torch(xyz, g)
        rows = {}
        for name, kern in versions:
            geometry = kern.fps_default(b, n)
            launch, out = kern.fps(xyz, g, geometry)
            launch()
            torch.cuda.synchronize()
            rows[name] = {"geometry": list(geometry), "equal": bool(torch.equal(out, want)),
                          "ms": [], "sweep": {}}
        # old, new, new, old: the two meet in turns
        order = [v for v in versions] + [v for v in reversed(versions)]
        for name, kern in order:
            rows[name]["ms"].append(_ms(kern.fps(xyz, g, kern.fps_default(b, n))[0]))
        for name, kern in versions:
            for geometry in kern.fps_sweep(b, n):
                rows[name]["sweep"][str(list(geometry))] = _try_ms(kern.fps(xyz, g, geometry)[0])
            ms = min(rows[name]["ms"])
            rows[name]["ms_per_round"] = ms / max(g - 1, 1)
            print(json.dumps({"kernel": "fps", "sources": name, "shape": [b, n, g], "gpu": gpu,
                              **rows[name]}), flush=True)


def knn_rows(versions: list[tuple[str, Kernels]], gpu: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for b, n, g, k in KNN_SHAPES:
        ref = torch.randn(b, n, 3, device="cuda", generator=gen)
        query = ref[:, :g].contiguous()
        want_d, want_i = knn_mod.knn_indices_torch(ref, query, k, return_dist=True)
        rows = {}
        for name, kern in versions:
            geometry = kern.knn_default(b, n, g, k)
            launch, (dist, idx, overflow) = kern.knn(ref, query, k, geometry)
            launch()
            torch.cuda.synchronize()
            row = {"geometry": list(geometry), "equal": bool(torch.equal(idx, want_i)),
                   "dist_equal": bool(torch.equal(dist, want_d)), "ms": [], "sweep": {}}
            if kern.new["knn"]:
                row["overflow"] = int(overflow.item())
                row["candidates"] = {}
                for runs in (2, 4):
                    _, _, stats = knn_mod.knn_select_emulated(ref, query, k, runs=runs)
                    c = stats["candidates"].to(torch.float64)
                    row["candidates"][runs] = {"mean": float(c.mean()), "max": int(c.max()),
                                               "overflow": int(stats["overflow"])}
            rows[name] = row
        order = [v for v in versions] + [v for v in reversed(versions)]
        for name, kern in order:
            rows[name]["ms"].append(_ms(kern.knn(ref, query, k, kern.knn_default(b, n, g, k))[0]))
        for name, kern in versions:
            for geometry in kern.knn_sweep(b, n, g, k):
                rows[name]["sweep"][str(list(geometry))] = _try_ms(
                    kern.knn(ref, query, k, geometry)[0])
            rows[name]["ns_per_query"] = min(rows[name]["ms"]) * 1e6 / (b * g)
            print(json.dumps({"kernel": "knn", "sources": name, "shape": [b, n, g, k], "gpu": gpu,
                              **rows[name]}), flush=True)


def ablation_rows(name: str, kern: Kernels, variants: dict, gpu: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(2)
    for what, patched in variants.items():
        if what.startswith("fps"):
            for b, n, g in FPS_ABLATION_SHAPES:
                xyz = torch.randn(b, n, 3, device="cuda", generator=gen)
                base = _ms(kern.fps(xyz, g, kern.fps_default(b, n))[0])
                ms = _ms(patched.fps(xyz, g, patched.fps_default(b, n))[0])
                print(json.dumps({"ablation": what, "sources": name, "shape": [b, n, g],
                                  "ms": ms, "whole_kernel_ms": base, "gpu": gpu}), flush=True)
        else:
            for b, n, g, k in KNN_ABLATION_SHAPES:
                ref = torch.randn(b, n, 3, device="cuda", generator=gen)
                query = ref[:, :g].contiguous()
                geometry = kern.knn_default(b, n, g, k)
                base = _ms(kern.knn(ref, query, k, geometry)[0])
                ms = _ms(patched.knn(ref, query, k, geometry)[0])
                print(json.dumps({"ablation": what, "sources": name, "shape": [b, n, g, k],
                                  "ms": ms, "whole_kernel_ms": base, "gpu": gpu}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=None,
                    help="another directory of CUDA sources, timed in turns with the package's")
    ap.add_argument("--csrc-only", action="store_true",
                    help="profile only the --csrc sources (not the package's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels needs a CUDA device")
    gpu = gpu_name_and_limit()
    sources = [] if args.csrc_only else [("package", _build.CSRC_DIR)]
    if args.csrc is not None:
        sources.insert(0, (str(args.csrc), args.csrc.resolve()))
    with tempfile.TemporaryDirectory() as tmp:
        versions, ablated = [], []
        for n, (name, csrc) in enumerate(sources):
            kern = Kernels(csrc, Path(tmp) / f"v{n}")
            versions.append((name, kern))
            for which in ("fps", "knn"):
                variants = (NEW_ABLATIONS if kern.new[which] else OLD_ABLATIONS)[which]
                for what, patches in variants.items():
                    dirname = re.sub(r"\W+", "_", f"v{n}_{which}_{what}")
                    try:
                        ablated.append((name, kern, f"{which}: {what}",
                                        Kernels(csrc, Path(tmp) / dirname, patches)))
                    except RuntimeError as e:
                        print(json.dumps({"ablation": f"{which}: {what}", "sources": name,
                                          "error": str(e)}), flush=True)
        for name, kern in versions:
            kern.wait()
            print(json.dumps({"build": name, "new_design": kern.new, "ptxas": kern.ptxas(),
                              "gpu": gpu}), flush=True)
        fps_rows(versions, gpu)
        knn_rows(versions, gpu)
        for name, kern, what, patched in ablated:
            try:
                patched.wait()
            except RuntimeError as e:
                print(json.dumps({"ablation": what, "sources": name, "error": str(e)[-2000:]}),
                      flush=True)
                continue
            ablation_rows(name, kern, {what: patched}, gpu)


if __name__ == "__main__":
    main()
