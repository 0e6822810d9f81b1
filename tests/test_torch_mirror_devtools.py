"""tests/test_devtools.py's own test bodies run against the port: the
rule fixtures, waivers, witness, and the real-tree gate, which here
lints the port's own tree (`src/repro_torch`) with the port's baseline.

Left out: the check that `docs/lock_hierarchy.md` is current. That file
is the JAX package's hierarchy and stays as it is;
`test_torch_devtools.py` renders the port's hierarchy and checks it."""
from pathlib import Path

from _torch_mirror import mirror

PORT_SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"

globals().update(mirror("test_devtools.py", skip={
    "test_hierarchy_doc_is_current":
        "docs/lock_hierarchy.md is the JAX package's generated hierarchy",
}, overrides={"SRC": PORT_SRC}))
