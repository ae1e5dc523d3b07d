# LSM storage engine: leveled sorted runs + fused reads (bloom/fence gated)
# + the per-run baseline read + WAL, snapshot manifest and crash recovery.
# Wired under ShardedTable (engine "lsm").
from .bloom import (bloom_build, bloom_maybe_contains,
                    bloom_maybe_contains_batch, fence_build, num_words,
                    suggest_hashes, theoretical_fp_rate)
from .engine import (LSMRuns, combine_triples, load_jax_state, plan_levels,
                     run_query_gated, run_query_rows)
from .manifest import recover, wal_path, write_snapshot
from .wal import WriteAheadLog

__all__ = [
    "LSMRuns", "WriteAheadLog", "bloom_build", "bloom_maybe_contains",
    "bloom_maybe_contains_batch", "combine_triples", "fence_build",
    "load_jax_state", "num_words", "plan_levels", "recover",
    "run_query_gated", "run_query_rows", "suggest_hashes",
    "theoretical_fp_rate", "wal_path", "write_snapshot",
]
