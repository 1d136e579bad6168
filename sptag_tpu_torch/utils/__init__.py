"""Small shape helpers shared with ``sptag_tpu/utils/__init__.py``.

The dense search keeps the JAX package's query padding ladder: group
membership in the grouped search depends on how a batch is padded, so it
is a parity rule, not a compile-cache device."""


def round_up(n: int, m: int) -> int:
    """Round n up to the next multiple of m."""
    return ((n + m - 1) // m) * m


QUERY_BUCKETS = (1, 8, 32, 128, 256, 1024)


def query_bucket(q: int, cap: int) -> int:
    """Pad q up to the smallest bucket, bounded by the caller's chunk cap."""
    for b in QUERY_BUCKETS:
        if q <= b:
            return min(b, cap)
    return min(round_up(q, QUERY_BUCKETS[-1]), cap)


def shape_bucket(x: int, lo: int = 32) -> int:
    """Quantize a padded dimension to a small ladder: powers of 4 below
    2^15, powers of 2 above.  The tree build pads each k-means batch to it,
    which also fixes how many centers a small node may seed."""
    if x >= (1 << 15):
        return 1 << max(0, (x - 1).bit_length())
    b = max(1, lo)
    while b < x:
        b *= 4
    if b >= (1 << 15):
        return 1 << max(0, (x - 1).bit_length())
    return b
