"""istore-lint: repo-specific concurrency & invariant static analysis.

Pure-stdlib (``ast``) analysis of the InfiniStore core, run as::

    python -m repro_torch.devtools.lint src/repro_torch

Five rules (each with a ``# lint: allow(<rule>): <reason>`` pragma and
a fingerprint baseline in ``baseline.json``):

- ``lock-order``        acquisition-graph cycles / plain-Lock self-deadlock
- ``blocking-under-lock`` sleeps, socket/pipe sends, ``future.result()``,
                        journal ``sync()``, COS I/O inside a lock region
- ``fault-site``        ``FaultPlan.fire`` guard + manifest discipline,
                        ``net.*``/``hb`` points must set ``match=``
- ``atomic-counter``    read-modify-write on ``StoreStats`` counters
- ``resource-lifecycle`` threads/pools/shared memory constructed in
                        ``__init__`` must be torn down from ``close()``

`repro_torch.devtools.witness.LockWitness` is the runtime half: it validates
the statically derived lock hierarchy against real acquisition orders
under the conformance suite and the chaos soak.
"""
