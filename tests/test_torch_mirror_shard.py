"""tests/test_shard.py's own test bodies run against the port (device="cpu").
Left out: the KV-cache test, whose body writes the cache's pools with
jax.numpy; test_torch_shard.py runs it over the port's pools."""
from _torch_mirror import mirror

globals().update(mirror("test_shard.py", skip={
    "test_kv_cache_store_backend_roundtrip":
        "writes the KV pools with jax.numpy",
}))
