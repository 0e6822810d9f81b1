"""Re-run the port's analyzer rules over the logs that `python -m
repro_torch.launch.dryrun --save-hlo` saved in experiments/torch_hlo/,
without tracing, refreshing `analysis`, `collectives_by_op` and
`memory.f32_upcast_bytes` of experiments/torch_dryrun.jsonl in place
(`scripts/reanalyze.py` over the port). Lets a byte or flop rule of
`repro_torch.analysis.hlo` be iterated without a full re-trace. Needs
no card: the rules run on meta tensors.

Records that are not ok, or whose cell has no log, are left as they
are. A record keeps its trace's memory but the upcast bytes, as the
reference recomputes no memory but those.

Usage: PYTHONPATH=src python scripts/torch_reanalyze.py
       [experiments/torch_dryrun.jsonl]
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.analysis.hlo import (analyze_hlo,  # noqa: E402
                                      bf16_upcast_f32_bytes)
from repro_torch.launch.dryrun import (DEFAULT_OUT, HLO_DIR,  # noqa: E402
                                      collectives_by_op)


def main() -> None:
    path = Path(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if line]
    n = 0
    for rec in recs:
        if not rec.get("ok"):
            continue
        log = HLO_DIR / (f"{rec['arch']}_{rec['shape']}_{rec['mesh']}"
                         f"{rec.get('tag', '')}.txt")
        if not log.exists():
            continue
        txt = log.read_text()
        multi = rec["mesh"].count("x") == 2
        a = analyze_hlo(txt, pod_stride=256 if multi else 10**9)
        rec["analysis"] = a.summary()
        rec["collectives_by_op"] = collectives_by_op(a.collectives)
        rec["memory"]["f32_upcast_bytes"] = bf16_upcast_f32_bytes(txt)
        n += 1
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    print(f"re-analyzed {n}/{len(recs)} records in {path}")


if __name__ == "__main__":
    main()
