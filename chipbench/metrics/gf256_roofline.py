"""The codec's GF(256) kernel against its byte bound over the traced
window: the least time of every decode product the window's GETs needed
((k + k) L + k k bytes at the HBM rate, L each object's chunk length)
over the kernel's time in the profiler, in %. Nothing to read where the
kernel ran another number of times than the GETs decoded."""
from chipbench.metrics import _counts


def read(run):
    if run.profile is None:
        return None
    ev = run.profile.kernels("gf256_small", "gf256_general")
    recs = run.log.get("recs", [])
    if not ev or len(ev) != len(recs):
        return None
    k = run.config["ec"]["k"]
    sizes = run.log["sizes"]
    nbytes = sum(_counts.gf256_bytes(
        k, k, _counts.rs_chunk_len(sizes[r[4]], k)) for r in recs)
    return 100.0 * _counts.bound_s(nbytes) / sum(s for _, s in ev)
