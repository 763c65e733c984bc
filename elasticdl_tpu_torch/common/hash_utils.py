"""Stable hashing used for parameter/row placement (copy of
elasticdl_tpu/common/hash_utils.py).

Dense parameters route to a shard by sha256(name) mod N; embedding rows
by id mod N; the serving router's consistent-hash ring places replica
vnodes and affinity keys by ``stable_u64``. These functions must stay
stable across processes, languages and the two packages: checkpoint
re-sharding on resume and a router's ring rebuilt after a restart
depend on them.
"""

import hashlib


def string_to_id(name: str, bucket_num: int) -> int:
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive, got %s" % bucket_num)
    digest = hashlib.sha256(name.encode("utf-8")).hexdigest()
    return int(digest, 16) % bucket_num


def int_to_id(value: int, bucket_num: int) -> int:
    if bucket_num <= 0:
        raise ValueError("bucket_num must be positive, got %s" % bucket_num)
    return int(value) % bucket_num


def stable_u64(token: str) -> int:
    """Process-stable 64-bit hash of a string token.

    The serving router's consistent-hash ring places replica
    vnodes and affinity keys on a shared u64 circle. Python's builtin
    ``hash`` is salted per process, so ring positions would differ between
    the router and any offline tooling replaying a journal; sha256 keeps
    placement reproducible the same way shard routing above does.
    """
    digest = hashlib.sha256(token.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def scatter_ids(ids, bucket_num: int):
    """Group embedding ids by destination shard.

    Returns {shard_id: [positions...]} so callers can both route ids and
    re-assemble the pulled rows in input order.
    """
    buckets = {}
    for pos, i in enumerate(ids):
        buckets.setdefault(int(i) % bucket_num, []).append(pos)
    return buckets
