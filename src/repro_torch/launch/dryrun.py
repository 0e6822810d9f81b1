"""Multi-pod dry-run: trace every (architecture x input shape) cell on
the production meshes and record per-rank memory, flops, bytes and
collectives (the JAX package's `launch/dryrun.py`).

The reference lowers and compiles each cell with GSPMD on 512
placeholder CPU devices. The port traces it: a fake world of 256 or 512
ranks in one process (`mesh.init_fake_world`), the cell's arguments
`place`d as DTensors whose local tensors are meta (no memory at any
size), and the cell's step run on them under its rules with DTensor
sharding propagation (`implicit_replication` for the plain tensors the
model makes), counted by `analysis.hlo.analyze` on this rank's local
ops. The outputs are redistributed to the cell's out shardings, as the
reference's jit does. This process is rank 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --mesh single

`--jobs N` traces N cells at once, each in a process of its own (one
fake world per process), their records appended to `--out` in cell order.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis.hlo import analyze
from repro_torch.configs import (ARCH_NAMES, SHAPES_BY_NAME, get_config,
                                 shapes_for)
from repro_torch.configs.base import ShapeConfig, padded_vocab
from repro_torch.distributed.sharding import (NamedSharding, installed_rules,
                                              pod_laid_out, per_pod,
                                              tree_leaves, tree_map)
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import (HW, init_fake_world,
                                     make_production_mesh)
from repro_torch.launch.steps import build_cell
from repro_torch.models.transformer import DTYPES

DEFAULT_OUT = Path("experiments/torch_dryrun.jsonl")
MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}


# --------------------------------------------------------------------------
# Memory from the shardings
# --------------------------------------------------------------------------

def local_shape(shape: Tuple[int, ...], sharding: NamedSharding
                ) -> Tuple[int, ...]:
    """This rank's shard of a `shape` tensor (rank 0's: the largest where
    a dim does not divide)."""
    out = list(shape)
    for dim, entry in enumerate(sharding.spec):
        names = () if entry is None else \
            (entry,) if isinstance(entry, str) else entry
        n = math.prod(sharding.mesh.shape[a] for a in names)
        out[dim] = -(-out[dim] // n)
    return tuple(out)


def local_bytes(tree: Any, shardings: Any) -> int:
    """Sum over the leaves of `tree` (tensors, meta ones included) of
    their shard's bytes under the matching `shardings`."""
    leaves, shs = tree_leaves(tree), tree_leaves(shardings)
    if len(leaves) != len(shs):
        raise ValueError(f"{len(leaves)} leaves, {len(shs)} shardings")
    return sum(math.prod(local_shape(tuple(x.shape), sh)) * x.element_size()
               for x, sh in zip(leaves, shs))


# --------------------------------------------------------------------------
# Tracing a cell
# --------------------------------------------------------------------------

def _meta_dtensor(x: torch.Tensor, sharding: NamedSharding):
    """x's shard on this rank as a DTensor whose local tensor is a meta
    tensor of its own (the shard's bytes, not a view of the whole)."""
    loc = torch.empty(local_shape(tuple(x.shape), sharding), dtype=x.dtype,
                      device="meta")
    return DTensor.from_local(loc, sharding.mesh.device_mesh,
                              sharding.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def trace_cell(cell: Dict, *, pod_stride: int):
    """Run the cell's step on meta DTensors under its rules and count it:
    returns the `HloAnalysis` (its `result` the step's outputs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    manual = cell["manual"]
    args = tree_map(_meta_dtensor, cell["args"], cell["in_shardings"])
    if manual:
        args = tree_map(lambda x: per_pod(x, manual), args)

    def run(*a):
        with installed_rules(cell["rules"]), implicit_replication():
            out = cell["step"](*a)
            return tree_map(lambda x, sh: pod_laid_out(x, sh, manual), out,
                            cell["out_shardings"])

    return analyze(run, *args, pod_stride=pod_stride)


def abstract_outputs(cell: Dict, shape: ShapeConfig):
    """The step's outputs as meta tensors: the new train state and three
    0-d f32 metrics; the last position's logits (in the model's dtype)
    and the cache; or the next tokens and the cache."""
    model, args = cell["model"], cell["args"]
    cfg = model.cfg
    if shape.kind == "train":
        f32 = torch.empty((), dtype=torch.float32, device="meta")
        return args[0], args[1], {"loss": f32, "grad_norm": f32, "lr": f32}
    B = shape.global_batch
    C = cfg.frontend.num_codebooks
    audio = cfg.frontend.kind == "audio" and C > 1
    cache = model.abstract_cache(B, shape.seq_len)
    if shape.kind == "prefill":
        V = padded_vocab(cfg.vocab_size)
        logits = torch.empty((B, 1, C, V) if audio else (B, 1, V),
                             dtype=DTYPES[cfg.dtype], device="meta")
        return logits, cache
    tok = torch.empty((B, 1, C) if audio else (B, 1), dtype=torch.int32,
                      device="meta")
    return tok, cache


def _same_layout(traced: Any, abstract: Any) -> None:
    """The traced outputs have the abstract ones' shapes and dtypes."""
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(traced)]
    want = [(tuple(t.shape), t.dtype) for t in tree_leaves(abstract)]
    if got != want:
        raise ValueError(f"the step's outputs {got} are not {want}")


def memory_record(cell: Dict, outputs: Any, peak_bytes: int) -> Dict:
    """The reference's `memory_analysis` fields from the shardings: the
    arguments' and outputs' shards (`outputs` a tree of tensors, meta
    ones included), the donated arguments (aliased by outputs), the
    trace's peak less the arguments as temporaries."""
    args, in_sh = cell["args"], cell["in_shardings"]
    arg_b = local_bytes(args, in_sh)
    out_b = local_bytes(outputs, cell["out_shardings"])
    alias_b = sum(local_bytes(args[i], in_sh[i])
                  for i in cell["donate_argnums"])
    mem = {"argument_bytes": arg_b, "output_bytes": out_b,
           "temp_bytes": max(peak_bytes - arg_b, 0), "alias_bytes": alias_b,
           "peak_bytes": peak_bytes}
    mem["total_bytes"] = (mem["argument_bytes"] + mem["output_bytes"]
                          + mem["temp_bytes"] - mem["alias_bytes"])
    return mem


def pod_gather_bytes(cell: Dict) -> int:
    """The compressed step's pod all-gathers by the placements: every
    rank gathers its int8 shard of each gradient and its f32 scale from
    each pod (the shard is the error-feedback state's, laid out as the
    master weights)."""
    pods = cell["in_shardings"][1]["err"]
    n = next(iter(tree_leaves(pods))).mesh.shape["pod"]
    return sum(n * (math.prod(local_shape(tuple(x.shape), sh)) + 4)
               for x, sh in zip(tree_leaves(cell["args"][1]["err"]),
                                tree_leaves(pods)))


def _check_pod_gather(cell: Dict, rec: Dict) -> None:
    want = pod_gather_bytes(cell)
    got = rec["collectives_by_op"].get("all-gather_dcn", {}).get(
        "result_bytes")
    rec["pod_gather_bytes"] = want
    if got != want:
        raise ValueError(f"the pod all-gather moved {got} bytes, the "
                         f"placements give {want}")


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             kv_layout: str = "paged", attn_impl: str = "masked",
             wkv_impl: str = "chunked", extra_tag: str = "",
             expert_sharding: str = "", microbatches: int = 0,
             grad_compress: bool = False, flash_decode: bool = False
             ) -> dict:
    """One cell's record. Needs the fake world of the mesh's size."""
    cfg = get_config(arch)
    if expert_sharding and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_sharding=expert_sharding))
    shape = SHAPES_BY_NAME[shape_name]
    if microbatches and shape.kind == "train":
        specs_lib.TRAIN_MICROBATCHES[arch] = microbatches
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rec = {
        "arch": arch, "shape": shape_name, "mesh": MESHES[multi_pod][0],
        "chips": MESHES[multi_pod][1], "kind": shape.kind,
        "kv_layout": kv_layout, "attn_impl": attn_impl,
        "wkv_impl": wkv_impl, "tag": extra_tag,
    }
    rec.update(record_cell(cfg, shape, mesh, kv_layout=kv_layout,
                           attn_impl=attn_impl, wkv_impl=wkv_impl,
                           grad_compress=grad_compress,
                           flash_decode=flash_decode,
                           pod_stride=256 if multi_pod else 10**9))
    return rec


def record_cell(cfg, shape: ShapeConfig, mesh, *, pod_stride: int,
                **cell_kw) -> dict:
    """`build_cell(cfg, shape, mesh, **cell_kw)` traced on `mesh` (over
    the fake world of its size): its memory, analysis and collectives,
    or the error."""
    rec: Dict[str, Any] = {}
    t0 = time.time()
    try:
        cell = build_cell(cfg, shape, mesh, **cell_kw)
        analysis = trace_cell(cell, pod_stride=pod_stride)
        t1 = time.time()
        _same_layout(analysis.result, abstract_outputs(cell, shape))
        rec["memory"] = memory_record(cell, analysis.result,
                                      analysis.peak_bytes)
        rec["analysis"] = analysis.summary()
        rec["collectives_by_op"] = {}
        for c in analysis.collectives:
            key = f"{c.opcode}{'_dcn' if c.dcn else ''}"
            d = rec["collectives_by_op"].setdefault(
                key, {"count": 0.0, "result_bytes": 0.0, "ring_bytes": 0.0})
            d["count"] += c.count
            d["result_bytes"] += c.result_bytes
            d["ring_bytes"] += c.ring_bytes
        if cell["manual"]:
            _check_pod_gather(cell, rec)
        rec["while_trips"] = analysis.while_trips[:50]
        rec["param_count"] = int(cell["model"].param_count())
        rec["trace_s"] = round(t1 - t0, 2)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        rec["elapsed_s"] = round(time.time() - t0, 2)
    return rec


def roofline_terms(analysis: dict) -> dict:
    """The compute, memory and collective terms (seconds) of a record's
    per-rank analysis under the H100's `HW`."""
    return {"compute_s": analysis["flops"] / HW["peak_flops_bf16"],
            "memory_s": analysis["bytes_accessed"] / HW["hbm_bw"],
            "collective_s": analysis["ici_ring_bytes"] / HW["ici_bw"]
            + analysis["dcn_ring_bytes"] / HW["dcn_bw"]}


def cells(arch_filter=None, shape_filter=None):
    for arch in ARCH_NAMES:
        if arch_filter and arch != arch_filter:
            continue
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if shape_filter and shape.name != shape_filter:
                continue
            yield arch, shape.name


def _done(out: Path) -> set:
    """(arch, shape, mesh, tag) of the cells `out` records as ok."""
    done = set()
    if out.exists():
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("tag", "")))
            except json.JSONDecodeError:
                pass
    return done


def _cell_flags(args) -> list:
    """The command-line flags of one cell's child process, as given."""
    flags = ["--kv-layout", args.kv_layout, "--attn-impl", args.attn_impl,
             "--wkv-impl", args.wkv_impl, "--tag", args.tag]
    if args.expert_sharding:
        flags += ["--expert-sharding", args.expert_sharding]
    if args.microbatches:
        flags += ["--microbatches", str(args.microbatches)]
    if args.grad_compress:
        flags.append("--grad-compress")
    if args.flash_decode:
        flags.append("--flash-decode")
    return flags


def _run_jobs(args, todo) -> int:
    """Every (cell, mesh) in a child process of its own, `args.jobs` at
    once, each writing a part file; the parts appended to `args.out` in
    cell order. Returns the number of failed cells."""
    from concurrent.futures import ThreadPoolExecutor
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    done = _done(out) if args.skip_existing else set()
    jobs = [(m, arch, shape) for m in meshes for arch, shape in todo
            if (arch, shape, MESHES[m == "multi"][0], args.tag) not in done]

    def one(i):
        mesh, arch, shape = jobs[i]
        part = out.with_name(f"{out.name}.{i}.part")
        part.unlink(missing_ok=True)
        log = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--arch", arch, "--shape",
             shape, "--mesh", mesh, "--out", str(part), *_cell_flags(args)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True).stdout
        print("".join(line + "\n" for line in log.splitlines()
                      if line.startswith(("[run", "[skip", "   "))), end="",
              flush=True)
        lines = part.read_text().splitlines() if part.exists() else []
        part.unlink(missing_ok=True)
        return lines

    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        parts = list(pool.map(one, range(len(jobs))))
    n_fail = 0
    with out.open("a") as f:
        for mesh in meshes:
            n_ok = n_bad = 0
            for (m, _, _), lines in zip(jobs, parts):
                if m != mesh:
                    continue
                for line in lines:
                    f.write(line + "\n")
                ok = bool(lines) and json.loads(lines[-1]).get("ok")
                n_ok, n_bad = n_ok + ok, n_bad + (not ok)
            name = MESHES[mesh == "multi"][0]
            print(f"done: {n_ok} ok, {n_bad} failed ({name}) -> {out}")
            n_fail += n_bad
    print(f"{len(jobs)} cells in {time.time() - t0:.1f} s, {args.jobs} at "
          f"once")
    return n_fail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "contiguous"])
    ap.add_argument("--attn-impl", default="masked", choices=["masked", "tri"])
    ap.add_argument("--wkv-impl", default="chunked",
                    choices=["chunked", "scan"])
    ap.add_argument("--expert-sharding", default="",
                    choices=["", "expert", "ffn"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback grad exchange over the pod "
                         "(DCN) axis")
    ap.add_argument("--flash-decode", action="store_true",
                    help="shard the KV cache over sequence/pages when "
                         "kv_heads < TP (flash-decoding style)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)

    todo = list(cells(args.arch, args.shape))
    if not todo:
        raise SystemExit(f"no cells match arch={args.arch} shape={args.shape}")
    if args.jobs > 1:
        if _run_jobs(args, todo):
            raise SystemExit(1)
        return
    if args.mesh == "both":
        # one fake world per process: each mesh runs in a child of its own
        rcs = [subprocess.run([sys.executable, "-m", __spec__.name, *argv,
                               "--mesh", mesh]).returncode
               for mesh in ("single", "multi")]
        if any(rcs):
            raise SystemExit(1)
        return
    multi = args.mesh == "multi"
    mesh_name, ranks = MESHES[multi]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = _done(out) if args.skip_existing else set()

    init_fake_world(ranks)
    n_ok = n_fail = 0
    with out.open("a") as f:
        for arch, shape_name in todo:
            if (arch, shape_name, mesh_name, args.tag) in done:
                print(f"[skip] {arch} {shape_name} {mesh_name}")
                continue
            print(f"[run ] {arch} {shape_name} {mesh_name} ...", flush=True)
            rec = run_cell(arch, shape_name, multi,
                           kv_layout=args.kv_layout,
                           attn_impl=args.attn_impl,
                           wkv_impl=args.wkv_impl,
                           expert_sharding=args.expert_sharding,
                           microbatches=args.microbatches,
                           grad_compress=args.grad_compress,
                           flash_decode=args.flash_decode,
                           extra_tag=args.tag)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if rec["ok"]:
                n_ok += 1
                a = rec["analysis"]
                terms = roofline_terms(a)
                print(f"   ok: {rec['memory']['total_bytes']} bytes/rank, "
                      f"flops/rank={a['flops']:.3e}, "
                      f"bytes/rank={a['bytes_accessed']:.3e}, "
                      f"collective bytes/rank={a['collective_bytes']:.3e}; "
                      f"under HW compute/memory/collective "
                      f"{terms['compute_s'] * 1e3:.1f}/"
                      f"{terms['memory_s'] * 1e3:.1f}/"
                      f"{terms['collective_s'] * 1e3:.1f} ms; "
                      f"trace={rec['trace_s']}s", flush=True)
            else:
                n_fail += 1
                print(f"   FAIL: {rec['error'][:200]}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed -> {out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
