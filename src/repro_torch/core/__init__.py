"""InfiniStore core on PyTorch: the single-node store's data path.

ServerlessMemory (sliding-window GC-bucket management + PlaceChunk
placement + slab pool) coupled with a persistent COS layer, RS erasure
coding on the device, insertion-log failure detection, and parallel
recovery, and the scale-out frontends over it: the keyspace-partitioned
`ShardedStore` with its cross-shard 2PC, and `ProcessShardedStore`, one
worker process per shard over shared-memory rings or TCP.
"""
from repro_torch.core.clock import Clock  # noqa: F401
from repro_torch.core.cos import COS  # noqa: F401
from repro_torch.core.costmodel import CostLedger  # noqa: F401
from repro_torch.core.ec import ECConfig, RSCodec  # noqa: F401
from repro_torch.core.faults import (COSThrottleError, FaultPlan,  # noqa: F401
                                     FaultPoint, InjectedCrash,
                                     InjectedFault, OpDeadlineExceeded,
                                     RetryPolicy, TransientCOSError)
from repro_torch.core.gc_window import (BucketState, GCConfig,  # noqa: F401
                                        SlidingWindow)
from repro_torch.core.host import (ProcessShardedStore,  # noqa: F401
                                   ShardWorkerDied)
from repro_torch.core.ipc import ArenaBroken, ShmArena  # noqa: F401
from repro_torch.core.insertion_log import InsertionLog, PutRecord  # noqa: F401
from repro_torch.core.payload import (Payload, as_u8,  # noqa: F401
                                      payload_nbytes, to_bytes)
from repro_torch.core.placement import PlacementManager  # noqa: F401
from repro_torch.core.prefetch import (PrefetchConfig,  # noqa: F401
                                       SequentialPrefetcher)
from repro_torch.core.recovery import RecoveryManager  # noqa: F401
from repro_torch.core.shard import (HashRouter, RangeRouter,  # noqa: F401
                                    ShardedStore)
from repro_torch.core.sms import SMS, Slab  # noqa: F401
from repro_torch.core.spill import SpillJournal, SpillStats  # noqa: F401
from repro_torch.core.store import (AtomicCounter,  # noqa: F401
                                    ConcurrentPutError, InfiniStore,
                                    StoreConfig, StoreFrontend,
                                    StoreStats)
from repro_torch.core.transport import (HeartbeatConfig,  # noqa: F401
                                        LocalTransport, ShardTransport,
                                        TcpTransport)
from repro_torch.core.versioning import (MetadataTable, Meta,  # noqa: F401
                                         PersistentBuffer)
from repro_torch.core.writeback import (StoreFuture,  # noqa: F401
                                        WritebackQueue)
from repro_torch.kernels.rs_gf256.ops import gf256_matmul  # noqa: F401
from repro_torch.kernels.rs_gf256.ref import (  # noqa: F401
    EXP_TABLE, LOG_TABLE, gf256_matmul_ref, gf_inv_matrix_np,
    gf_matmul_np, gf_mul_np)
