from .sharded import (
    ShardedKmerCounter,
    build_sharded_em_step,
    build_sharded_search_step,
    hash_shard,
)
