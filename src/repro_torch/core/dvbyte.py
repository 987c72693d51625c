"""VByte and Double-VByte codecs (paper §2.2, §3.4, Algorithm 2).

The paper uses the Büttcher–Clarke VByte variant with the *null-byte sentinel*
property: the all-zero byte can only be produced by encoding x == 0, so as long
as every encoded value is strictly positive, a 0x00 byte unambiguously marks
"end of sequence" (or "unused trailing space in a block").

The only byte-oriented little-endian base-128 layout with that property is the
standard LEB128 one:

  * non-final bytes carry the continuation flag (top bit SET, value >= 0x80),
  * the final byte carries the top 7-bit group with the top bit CLEAR,
  * groups are emitted least-significant first.

Proof of the sentinel property: a continuation byte is >= 0x80, never null; the
final byte of a multi-byte code holds the most-significant group, which is
non-zero by minimality; a single-byte code is null iff x == 0.  (The paper's
prose describes the flag polarity the other way around, but that polarity would
emit a null byte inside the code of e.g. x == 128, contradicting the paper's own
sentinel claim in §2.2 — so we implement the layout that makes the system
sound, and note the discrepancy here.)

Double-VByte (Algorithm 2) folds a (g, f) pair into one integer when f < F:

    g' = (g - 1) * F + f          # f in 1..F-1  ->  g' mod F == f  != 0
    g' = g * F ; then f - F + 1   # escape       ->  g' mod F == 0

Both branches keep every emitted integer >= 1, preserving the sentinel.

This module provides scalar encoders/decoders (byte-exact, used by the block
store) and vectorized numpy codecs (used by benchmarks and as the host-side
oracle for the Pallas kernel).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "vbyte_len",
    "vbyte_encode_into",
    "vbyte_decode_from",
    "vbyte_encode",
    "vbyte_decode_stream",
    "dvbyte_len",
    "dvbyte_encode_into",
    "dvbyte_decode_from",
    "vbyte_encode_array",
    "vbyte_decode_array",
    "dvbyte_encode_pairs",
    "dvbyte_decode_pairs",
]

# --------------------------------------------------------------------------
# Scalar codec (byte-exact; hot path of the host ingest engine)
# --------------------------------------------------------------------------


def vbyte_len(x: int) -> int:
    """Number of bytes the VByte code of ``x`` occupies (x >= 0)."""
    n = 1
    while x >= 0x80:
        x >>= 7
        n += 1
    return n


def vbyte_encode_into(buf, pos: int, x: int) -> int:
    """Write the VByte code of ``x`` into ``buf`` at ``pos``; return new pos."""
    while x >= 0x80:
        buf[pos] = 0x80 | (x & 0x7F)
        pos += 1
        x >>= 7
    buf[pos] = x  # top bit clear: final byte
    return pos + 1


def vbyte_decode_from(buf, pos: int):
    """Decode one VByte value from ``buf`` at ``pos``; return (value, new pos)."""
    x = 0
    shift = 0
    while True:
        b = int(buf[pos])
        pos += 1
        if b & 0x80:
            x |= (b & 0x7F) << shift
            shift += 7
        else:
            x |= b << shift
            return x, pos


def vbyte_encode(values) -> bytes:
    """Encode an iterable of non-negative ints to a byte string."""
    out = bytearray()
    for x in values:
        x = int(x)
        while x >= 0x80:
            out.append(0x80 | (x & 0x7F))
            x >>= 7
        out.append(x)
    return bytes(out)


def vbyte_decode_stream(buf, pos: int = 0, end: int | None = None,
                        sentinel: bool = True):
    """Decode VByte values until ``end``.  Yields ints.

    With ``sentinel=True`` (the block-store convention) a null byte terminates
    the stream — callers must have guaranteed x > 0 for all encoded values.
    """
    if end is None:
        end = len(buf)
    while pos < end:
        if sentinel and buf[pos] == 0:  # null sentinel: padding / end of block
            return
        x, pos = vbyte_decode_from(buf, pos)
        yield x


# --------------------------------------------------------------------------
# Double-VByte (Algorithm 2)
# --------------------------------------------------------------------------


def dvbyte_len(g: int, f: int, F: int) -> int:
    """Length in bytes of the Double-VByte code for (g, f) with threshold F."""
    if f < F:
        return vbyte_len((g - 1) * F + f)
    return vbyte_len(g * F) + vbyte_len(f - F + 1)


def dvbyte_encode_into(buf, pos: int, g: int, f: int, F: int) -> int:
    """Algorithm 2 ``double_vbyte_encode``: write (g, f) into ``buf``.

    Requires g >= 1 and f >= 1 (guaranteed for doc-level postings; word-level
    callers pre-shift their d-gaps by +1 per paper §5.1).
    """
    if f < F:
        return vbyte_encode_into(buf, pos, (g - 1) * F + f)
    pos = vbyte_encode_into(buf, pos, g * F)
    return vbyte_encode_into(buf, pos, f - F + 1)


def dvbyte_decode_from(buf, pos: int, F: int):
    """Algorithm 2 ``double_vbyte_decode``: return ((g, f), new pos)."""
    gp, pos = vbyte_decode_from(buf, pos)
    r = gp % F
    if r > 0:
        return (1 + gp // F, r), pos
    f2, pos = vbyte_decode_from(buf, pos)
    return (gp // F, F + f2 - 1), pos


# --------------------------------------------------------------------------
# Vectorized numpy codecs (whole-array encode/decode, Table 4 benchmark and
# the oracle for kernels/dvbyte_decode)
# --------------------------------------------------------------------------


def _vbyte_lens_vec(values: np.ndarray) -> np.ndarray:
    """Vectorized vbyte_len for a uint64/int64 array of non-negative values."""
    v = values.astype(np.uint64)
    n = np.ones(v.shape, dtype=np.int64)
    for k in (7, 14, 21, 28, 35):
        n += (v >= (np.uint64(1) << np.uint64(k))).astype(np.int64)
    return n


def vbyte_encode_array(values: np.ndarray) -> np.ndarray:
    """Encode a 1-D array of non-negative ints; returns a uint8 array.

    Fully vectorized: computes per-value code lengths, prefix-sums offsets,
    then scatters all k-th bytes of all codes in one shot per k.
    """
    v = np.asarray(values, dtype=np.uint64).ravel()
    lens = _vbyte_lens_vec(v)
    offs = np.concatenate([[0], np.cumsum(lens)])
    total = int(offs[-1])
    out = np.zeros(total, dtype=np.uint8)
    maxlen = int(lens.max()) if len(lens) else 0
    for k in range(maxlen):
        sel = lens > k
        grp = ((v[sel] >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(np.uint8)
        last = lens[sel] == k + 1
        grp = np.where(last, grp, grp | np.uint8(0x80))
        out[offs[:-1][sel] + k] = grp
    return out


def vbyte_decode_array(buf: np.ndarray, count: int | None = None) -> np.ndarray:
    """Decode a uint8 array of back-to-back VByte codes to a uint64 array.

    Data-parallel structure (this is exactly what the Pallas kernel does on
    TPU): terminator flags -> exclusive scan gives each byte its value index
    and its within-code position, then all payloads are combined with shifts
    via a segmented reduction.
    """
    b = np.asarray(buf, dtype=np.uint8).ravel()
    if count is not None:
        # trim trailing sentinel padding
        pass
    term = (b & 0x80) == 0  # final byte of each code
    # value index of each byte = number of terminators strictly before it
    vidx = np.cumsum(term) - term.astype(np.int64)
    nvals = int(term.sum())
    # position within code: byte_index - start_of_code
    starts = np.zeros(nvals, dtype=np.int64)
    ends = np.flatnonzero(term)
    starts[1:] = ends[:-1] + 1
    pos_in_code = np.arange(len(b), dtype=np.int64) - starts[vidx]
    payload = (b & np.uint8(0x7F)).astype(np.uint64) << (
        np.uint64(7) * pos_in_code.astype(np.uint64)
    )
    vals = np.zeros(nvals, dtype=np.uint64)
    np.add.at(vals, vidx, payload)
    if count is not None:
        vals = vals[:count]
    return vals


def dvbyte_encode_pairs(g: np.ndarray, f: np.ndarray, F: int) -> np.ndarray:
    """Vectorized Double-VByte for arrays of (g, f) pairs -> uint8 stream."""
    g = np.asarray(g, dtype=np.uint64)
    f = np.asarray(f, dtype=np.uint64)
    if np.any(g < 1) or np.any(f < 1):
        raise ValueError("Double-VByte requires g >= 1 and f >= 1")
    small = f < F
    # folded primary values
    prim = np.where(small, (g - 1) * np.uint64(F) + f, g * np.uint64(F))
    # escape values interleave after their primary
    n = len(g)
    n_out = n + int((~small).sum())
    vals = np.empty(n_out, dtype=np.uint64)
    # output slot of each primary = index + (# escapes before it)
    esc_before = np.cumsum(~small) - (~small).astype(np.int64)
    pslot = np.arange(n) + esc_before
    vals[pslot] = prim
    vals[pslot[~small] + 1] = f[~small] - np.uint64(F) + np.uint64(1)
    return vbyte_encode_array(vals)


def dvbyte_decode_pairs(buf: np.ndarray, F: int, count: int | None = None):
    """Decode a Double-VByte uint8 stream back to (g, f) uint64 arrays."""
    vals = vbyte_decode_array(buf)
    # primaries are: the first value, and any value following a completed pair.
    # A value v is an escape iff the *previous primary* had v_prim % F == 0.
    # Scan-free trick: walk with a vectorized two-state automaton is not
    # possible without a scan because escapes consume a slot; do a fast loop
    # over the (rare) escape positions instead.
    mods = vals % np.uint64(F)
    g_out = []
    f_out = []
    i = 0
    n = len(vals)
    # bulk path: find runs with no escapes
    while i < n:
        if mods[i] != 0:
            # run of non-escape primaries
            j = i
            while j < n and mods[j] != 0:
                j += 1
            g_out.append(1 + vals[i:j] // np.uint64(F))
            f_out.append(mods[i:j])
            i = j
        else:
            g_out.append(vals[i : i + 1] // np.uint64(F))
            f_out.append(np.uint64(F) + vals[i + 1 : i + 2] - np.uint64(1))
            i += 2
    g = np.concatenate(g_out) if g_out else np.zeros(0, np.uint64)
    f = np.concatenate(f_out) if f_out else np.zeros(0, np.uint64)
    if count is not None:
        g, f = g[:count], f[:count]
    return g, f
