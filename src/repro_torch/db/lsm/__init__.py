# LSM storage engine: leveled sorted runs + fused reads (bloom/fence gated).
# Wired under ShardedTable (engine "lsm").
from .bloom import (bloom_build, bloom_maybe_contains,
                    bloom_maybe_contains_batch, fence_build, num_words,
                    suggest_hashes, theoretical_fp_rate)
from .engine import LSMRuns, combine_triples, load_jax_state, plan_levels

__all__ = [
    "LSMRuns", "bloom_build", "bloom_maybe_contains",
    "bloom_maybe_contains_batch", "combine_triples", "fence_build",
    "load_jax_state", "num_words", "plan_levels", "suggest_hashes",
    "theoretical_fp_rate",
]
