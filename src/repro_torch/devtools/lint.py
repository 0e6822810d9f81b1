"""istore-lint driver: run all rules, apply pragmas + baseline, report.

    python -m repro_torch.devtools.lint src/repro_torch
    python -m repro_torch.devtools.lint src/repro_torch --emit-hierarchy docs/lock_hierarchy.md
    python -m repro_torch.devtools.lint src/repro_torch --write-baseline

Exit status 0 iff every finding is waived by an inline pragma
(``# lint: allow(<rule>): <reason>`` on the finding's line or the line
above — the reason is mandatory) or by a fingerprint in the baseline
file (``src/repro_torch/devtools/baseline.json`` by default).  Fingerprints
are ``rule|path|scope|detail`` — line-number independent, so routine
edits don't churn the baseline.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.devtools import lockgraph, rules
from repro_torch.devtools.scan import Finding, TreeModel, scan_tree

DEFAULT_BASELINE = Path(__file__).with_name("baseline.json")


def collect_findings(tm: TreeModel) -> List[Finding]:
    order_findings, _edges = lockgraph.check(tm)
    out = list(order_findings)
    out += rules.blocking_under_lock(tm)
    out += rules.fault_site(tm)
    out += rules.metric_site(tm)
    out += rules.atomic_counter(tm)
    out += rules.resource_lifecycle(tm)
    return out


def apply_waivers(tm: TreeModel, findings: Sequence[Finding],
                  baseline: Dict[str, str]) -> Tuple[List[Finding],
                                                     List[Finding],
                                                     List[Finding]]:
    """-> (new, pragma_waived, baseline_waived).  A pragma with no
    reason does NOT waive — it surfaces as its own finding instead."""
    by_path = {mm.relpath: mm for mm in tm.modules.values()}
    new: List[Finding] = []
    pragma_waived: List[Finding] = []
    base_waived: List[Finding] = []
    for f in findings:
        mm = by_path.get(f.path)
        pragma = tm.pragma_for(mm, f.rule, f.line) if mm else None
        if pragma is not None:
            if not pragma[1]:
                new.append(Finding(
                    rule=f.rule, path=f.path, line=f.line, scope=f.scope,
                    detail=f.detail + "|no-reason",
                    message=(f"pragma waives this finding but gives no "
                             f"reason — `# lint: allow({f.rule}): <why>` "
                             f"(original: {f.message})")))
            else:
                pragma_waived.append(f)
            continue
        if f.fingerprint in baseline:
            base_waived.append(f)
            continue
        new.append(f)
    return new, pragma_waived, base_waived


def load_baseline(path: Path) -> Dict[str, str]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {e["fingerprint"]: e.get("reason", "")
            for e in data.get("findings", [])}


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    entries = [{"rule": f.rule, "fingerprint": f.fingerprint,
                "reason": "baselined pre-existing finding",
                "message": f.message}
               for f in sorted(findings,
                               key=lambda f: (f.path, f.line, f.rule))]
    path.write_text(json.dumps(
        {"comment": ("istore-lint waiver baseline. Entries are "
                     "fingerprints (rule|path|scope|detail), line-number "
                     "independent. Prefer inline pragmas with reasons; "
                     "baseline only what cannot carry a pragma."),
         "findings": entries}, indent=2) + "\n")


def run(targets: Sequence[str], *, baseline_path: Optional[Path] = None,
        root: Optional[Path] = None) -> Tuple[List[Finding], TreeModel]:
    """Programmatic entry: (new findings, tree model)."""
    tm = scan_tree(list(targets), root)
    baseline = load_baseline(baseline_path or DEFAULT_BASELINE)
    new, _, _ = apply_waivers(tm, collect_findings(tm), baseline)
    return new, tm


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.devtools.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*", default=["src/repro_torch"],
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline JSON (default: devtools/baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--emit-hierarchy", metavar="PATH",
                    help="write the generated lock-hierarchy doc "
                         "(use '-' for stdout)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    tm = scan_tree(args.targets)
    findings = collect_findings(tm)
    baseline = {} if args.no_baseline else load_baseline(Path(args.baseline))
    new, pragma_waived, base_waived = apply_waivers(tm, findings, baseline)

    if args.emit_hierarchy:
        _, edges = lockgraph.check(tm)
        doc = lockgraph.render_hierarchy(tm, edges)
        if args.emit_hierarchy == "-":
            sys.stdout.write(doc)
        else:
            Path(args.emit_hierarchy).write_text(doc)
            if not args.quiet:
                print(f"wrote {args.emit_hierarchy}")

    if args.write_baseline:
        write_baseline(Path(args.baseline), new)
        print(f"baselined {len(new)} findings -> {args.baseline}")
        return 0

    for f in sorted(new, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    stale = set(baseline) - {f.fingerprint for f in findings}
    if stale and not args.quiet:
        for fp in sorted(stale):
            print(f"note: stale baseline entry (fixed?): {fp}",
                  file=sys.stderr)
    if not args.quiet:
        mods = len(tm.modules)
        print(f"istore-lint: {mods} modules, {len(tm.locks)} locks, "
              f"{len(new)} new finding(s), "
              f"{len(pragma_waived)} pragma-waived, "
              f"{len(base_waived)} baselined", file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
