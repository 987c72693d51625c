"""The fixed-block index array ``I`` (paper §3.2 Figure 3, §3.3 Algorithm 1).

The whole dynamic index is one flat byte array, logically divided into B-byte
*slots*.  Every term owns a chain of blocks inside that array:

  head block   [n_ptr|d_num 4][t_ptr 4][last_d 4][ft 4][nx][tlen][term ...][postings ... 0 0]
  full block   [n_ptr 4][postings .................................... 0 0]
  tail block   [d_num 4][postings ... <write cursor H.nx> .................]

Notes on the layout (inferred byte-exactly from the paper):

  * H.nx is initialised to 4h + 2 + |t| = 18 + |t|  (§3.3), so the head holds
    four 4-byte fields (n_ptr, t_ptr, last_d, ft) plus one byte of nx and one
    byte of term length before the term string.  Table 7 confirms: head "link
    pointers" = 8 B/term (n_ptr + t_ptr) and "vocabulary" = last_d + ft + nx +
    tlen + term = 10 + |t| bytes/term.
  * Slot 0 of every block is *shared* between d_num (first docid in the block,
    live while the block is the tail — Algorithm 1 line 8/12) and n_ptr (chain
    link, written when the block stops being the tail — line 13).  The head
    block participates too: its slot 0 is d_num until the chain grows.
  * Variable-block mode (§5.4) adds two bytes to the head: nx widens to two
    bytes and a one-byte z (block-sequence position) is added, so postings
    start at 20 + |t|.  Block z's size is recomputed from the deterministic
    growth schedule (see extensible.py).
  * Word-level mode (§5.1) additionally tracks last_w (4 bytes) in the head so
    w-gaps within a document can be formed; postings start 4 bytes later.

All postings are Double-VByte coded (Algorithm 2); F=1 degenerates to two
plain VByte codes per posting.  Unused trailing bytes are null, which the
decoder recognises as end-of-block (the sentinel property, §2.2).

Pointers (n_ptr, t_ptr) are *slot offsets* in units of B bytes — the paper's
"array offsets ... rather than byte-addressed pointers", h = 4 bytes each,
capping the index at 2^32 blocks.
"""

from __future__ import annotations

import numpy as np

from .dvbyte import (
    dvbyte_decode_from,
    dvbyte_encode_into,
    dvbyte_len,
    vbyte_decode_from,
)
from .extensible import Const, GrowthPolicy

H = 4  # link-pointer width in bytes (paper: h = 4)

# head-block field offsets
_OFF_NPTR = 0  # shared with d_num
_OFF_TPTR = 4
_OFF_LASTD = 8
_OFF_FT = 12
_OFF_NX = 16  # 1 byte (const) or 2 bytes (variable)


class BlockStore:
    """The index array ``I`` plus Algorithm 1.

    Parameters
    ----------
    B:        base block size in bytes (paper sweeps 40..80; 64 is typical)
    policy:   growth policy (Const/Expon/Triangle); Const is the paper's §3
    F:        Double-VByte fold threshold (4 doc-level, 3 word-level, 1=VByte)
    word_level: store ⟨d,w⟩ postings (§5.1) instead of ⟨d,f⟩
    """

    def __init__(self, B: int = 64, policy: GrowthPolicy | None = None,
                 F: int = 4, word_level: bool = False,
                 initial_slots: int = 1024):
        if policy is None:
            policy = Const(B=B)
        if policy.B != B:
            raise ValueError("policy base size must equal B")
        if B < 40:
            raise ValueError("block sizes less than 40 cannot be used (§4.4)")
        self.B = B
        self.policy = policy
        self.const_mode = policy.is_const()
        if self.const_mode and B > 255:
            raise ValueError("Const mode needs B <= 255 (1-byte nx)")
        self.F = F
        self.word_level = word_level
        self.I = np.zeros(initial_slots * B, dtype=np.uint8)
        self.nblocks = 0  # global slot counter (Algorithm 1's nblocks)
        # head-layout geometry
        self.nx_width = 1 if self.const_mode else 2
        self.z_width = 0 if self.const_mode else 1
        self.lastw_width = 4 if word_level else 0
        # postings start inside a head block at: 16 + nx + z + lastw + 1 + |t|
        self.head_fixed = 16 + self.nx_width + self.z_width + self.lastw_width + 1

    # ------------------------------------------------------------------
    # low-level field accessors (little-endian ints inside the byte array)
    # ------------------------------------------------------------------

    def _get_u32(self, byte_off: int) -> int:
        return int(self.I[byte_off:byte_off + 4].view(np.uint32)[0])

    def _set_u32(self, byte_off: int, v: int) -> None:
        self.I[byte_off:byte_off + 4].view(np.uint32)[0] = v

    def _slot_base(self, ptr: int) -> int:
        return ptr * self.B

    # head-block field access; ``hb`` = byte offset of the head block
    def get_tptr(self, hb: int) -> int:
        return self._get_u32(hb + _OFF_TPTR)

    def set_tptr(self, hb: int, v: int) -> None:
        self._set_u32(hb + _OFF_TPTR, v)

    def get_lastd(self, hb: int) -> int:
        return self._get_u32(hb + _OFF_LASTD)

    def set_lastd(self, hb: int, v: int) -> None:
        self._set_u32(hb + _OFF_LASTD, v)

    def get_ft(self, hb: int) -> int:
        return self._get_u32(hb + _OFF_FT)

    def set_ft(self, hb: int, v: int) -> None:
        self._set_u32(hb + _OFF_FT, v)

    def get_nx(self, hb: int) -> int:
        if self.nx_width == 1:
            return int(self.I[hb + _OFF_NX])
        return int(self.I[hb + _OFF_NX]) | (int(self.I[hb + _OFF_NX + 1]) << 8)

    def set_nx(self, hb: int, v: int) -> None:
        self.I[hb + _OFF_NX] = v & 0xFF
        if self.nx_width == 2:
            self.I[hb + _OFF_NX + 1] = (v >> 8) & 0xFF

    def get_z(self, hb: int) -> int:
        if self.const_mode:
            return 0  # unused: every block is B bytes
        return int(self.I[hb + _OFF_NX + 2])

    def set_z(self, hb: int, v: int) -> None:
        if not self.const_mode:
            self.I[hb + _OFF_NX + 2] = min(v, 255)

    def get_lastw(self, hb: int) -> int:
        return self._get_u32(hb + 16 + self.nx_width + self.z_width)

    def set_lastw(self, hb: int, v: int) -> None:
        self._set_u32(hb + 16 + self.nx_width + self.z_width, v)

    def term_bytes(self, hb: int) -> bytes:
        tl_off = hb + self.head_fixed - 1
        tlen = int(self.I[tl_off])
        return bytes(self.I[tl_off + 1:tl_off + 1 + tlen])

    # ------------------------------------------------------------------
    # block geometry
    # ------------------------------------------------------------------

    def block_size_at(self, z: int) -> int:
        """Size in bytes of the z-th block (1-based) of any chain."""
        if self.const_mode:
            return self.B
        return self.policy.block_size(z, H)

    def _slots_for(self, nbytes: int) -> int:
        return (nbytes + self.B - 1) // self.B

    def clone(self) -> "BlockStore":
        """Deep snapshot: a private copy of the index array.  The lifecycle's
        background freeze thread reads the clone while ingest keeps writing
        into the original — they share no mutable state (the growth policy is
        stateless and safely shared)."""
        out = BlockStore.__new__(BlockStore)
        out.B = self.B
        out.policy = self.policy
        out.const_mode = self.const_mode
        out.F = self.F
        out.word_level = self.word_level
        out.I = self.I[: self.nblocks * self.B].copy()
        out.nblocks = self.nblocks
        out.nx_width = self.nx_width
        out.z_width = self.z_width
        out.lastw_width = self.lastw_width
        out.head_fixed = self.head_fixed
        return out

    def _ensure_capacity(self, extra_slots: int) -> None:
        need = (self.nblocks + extra_slots) * self.B
        if need > len(self.I):
            new = max(need, 2 * len(self.I))
            grown = np.zeros(new, dtype=np.uint8)
            grown[: len(self.I)] = self.I
            self.I = grown

    # ------------------------------------------------------------------
    # term creation (§3.3: "an empty head block is allocated")
    # ------------------------------------------------------------------

    def new_head(self, term: bytes) -> int:
        """Allocate a head block for a new term; returns its slot pointer."""
        if len(term) > 255:
            raise ValueError("terms are broken at 20 chars upstream; >255 invalid")
        first_size = self.block_size_at(1)
        slots = self._slots_for(first_size)
        self._ensure_capacity(slots)
        h_ptr = self.nblocks
        self.nblocks += slots
        hb = self._slot_base(h_ptr)
        start = self.head_fixed + len(term)
        if start + 2 > first_size:
            raise ValueError(
                f"term of {len(term)} bytes cannot fit a head block of {first_size}")
        # zero-init is already guaranteed; set fields
        self.set_tptr(hb, h_ptr)  # head is its own tail initially
        self.set_lastd(hb, 0)
        self.set_ft(hb, 0)
        self.set_nx(hb, start)
        self.set_z(hb, 1)
        self.I[hb + self.head_fixed - 1] = len(term)
        self.I[hb + self.head_fixed:hb + self.head_fixed + len(term)] = (
            np.frombuffer(term, dtype=np.uint8))
        return h_ptr

    # ------------------------------------------------------------------
    # Algorithm 1: add_posting
    # ------------------------------------------------------------------

    def add_posting(self, h_ptr: int, d: int, second: int) -> None:
        """Append posting ⟨d, second⟩ for the term whose head block is h_ptr.

        ``second`` is f (doc-level) or the w-gap payload (word-level; caller
        computes w-gaps, we compute d-gaps).  Faithful to Algorithm 1 with the
        word-level +1 shift of §5.1 and variable blocks of §5.4.
        """
        B, F = self.B, self.F
        hb = self._slot_base(h_ptr)
        t_ptr = self.get_tptr(hb)
        tb = self._slot_base(t_ptr)
        last_d = self.get_lastd(hb)
        if self.word_level:
            gap = d - last_d + 1  # §5.1: +1 so the coded value is > 0
            major, minor = second, gap  # double_vbyte_encode(w, g) — the twist
        else:
            gap = d - last_d
            major, minor = gap, second
        virgin = self.get_ft(hb) == 0
        nbytes = dvbyte_len(major, minor, F)
        nx = self.get_nx(hb)
        z = self.get_z(hb) if not self.const_mode else None
        tail_cap = B if self.const_mode else self.block_size_at(z)
        if nx + nbytes > tail_cap:  # line 6: posting does not fit
            # line 8: b-gap relative to the first docnum of the (old) tail
            t_dnum = self._get_u32(tb + _OFF_NPTR)
            if self.word_level:
                bgap = d - t_dnum + 1
                major, minor = second, bgap
            else:
                bgap = d - t_dnum
                major, minor = bgap, second
            # line 11: close off the old tail with null bytes
            old_end = tb + tail_cap
            self.I[tb + nx:old_end] = 0
            # allocate the new tail block (lines 10/13/15)
            new_z = (z + 1) if z is not None else 2
            new_size = self.block_size_at(new_z)
            slots = self._slots_for(new_size)
            self._ensure_capacity(slots)
            new_ptr = self.nblocks
            self.nblocks += slots
            nb = self._slot_base(new_ptr)
            self._set_u32(nb + _OFF_NPTR, d)        # line 12: T.d_num <- d
            self._set_u32(tb + _OFF_NPTR, new_ptr)  # line 13: F.n_ptr <- nblocks
            self.set_tptr(hb, new_ptr)              # line 13: H.t_ptr
            self.set_nx(hb, H)                      # line 14
            self.set_z(hb, new_z)
            t_ptr, tb = new_ptr, nb
            nx = H
            nbytes = dvbyte_len(major, minor, F)    # line 16 (b-gap recode)
        elif virgin:
            # first posting lands in the head: slot 0 doubles as d_num while
            # the head is still the tail (it is 0 — "no postings yet" — until
            # now, which is what makes the first b-gap come out as d itself).
            self._set_u32(hb + _OFF_NPTR, d)
        # line 17: code the posting into the tail at T[H.nx]
        pos = dvbyte_encode_into(self.I, tb + nx, major, minor, F)
        self.set_nx(hb, pos - tb)   # line 18
        self.set_lastd(hb, d)       # line 19
        self.set_ft(hb, self.get_ft(hb) + 1)  # line 20

    def append_run(self, h_ptr: int, postings) -> None:
        """Append a run of postings ``[(d, second), ...]`` for one term.

        The batched write path: equivalent to calling :meth:`add_posting`
        once per pair (the decoded chain is identical), but the head fields
        (t_ptr, last_d, ft, nx, the tail's d_num) are hoisted into locals
        for the whole run, and the run is Double-VByte coded CONTIGUOUSLY
        into one staging bytearray that is flushed into the block array
        with a single slice assignment per block segment — the per-posting
        accessor walk that dominates ``add_document`` is paid once per run
        instead.  Only a block-boundary posting is recoded mid-stage (its
        b-gap changes, Algorithm 1 line 8; everything after it is coded
        relative to its predecessor and is unaffected).

        ``postings`` must be in ingest order (ascending d; word-level runs
        repeat d once per occurrence, in word order) — exactly the per-term
        subsequence a sequential ingest would have produced.
        """
        B, F = self.B, self.F
        word = self.word_level
        const = self.const_mode
        I = self.I
        hb = h_ptr * B
        # one slice view reads all four head u32s (vs four accessor calls)
        d_num, t_ptr, last_d, ft = I[hb:hb + 16].view(np.uint32).tolist()
        tb = t_ptr * B
        nx = int(I[hb + 16])
        if not const:
            nx |= int(I[hb + 17]) << 8
        z = 1 if const else int(I[hb + 18])
        tail_cap = B if const else self.block_size_at(z)
        # first docnum of the current tail (slot 0 — d_num while tail)
        t_dnum = d_num if t_ptr == h_ptr else self._get_u32(tb + _OFF_NPTR)
        buf = bytearray()
        ba = buf.append
        flush_at = tb + nx          # byte offset the staged run lands at
        for d, second in postings:
            # Algorithm 2 inlined, size-first: the code's byte length is
            # arithmetic on the folded value, so the fit check (line 6)
            # runs before any byte is staged — no rollback
            if word:
                major, minor = second, d - last_d + 1
            else:
                major, minor = d - last_d, second
            if minor < F:
                x = (major - 1) * F + minor
                y = 0
                nbytes = 1 if x < 0x80 else 2 if x < 0x4000 else \
                    3 if x < 0x200000 else 4 if x < 0x10000000 else 5
            else:
                x = major * F
                y = minor - F + 1
                nbytes = (1 if x < 0x80 else 2 if x < 0x4000 else
                          3 if x < 0x200000 else 4 if x < 0x10000000 else 5) \
                    + (1 if y < 0x80 else 2 if y < 0x4000 else
                       3 if y < 0x200000 else 4 if y < 0x10000000 else 5)
            if nx + nbytes > tail_cap:      # Algorithm 1 line 6
                # recode relative to the old tail's first docnum (line 8)
                if word:
                    minor = d - t_dnum + 1
                else:
                    major = d - t_dnum
                if minor < F:
                    x, y = (major - 1) * F + minor, 0
                else:
                    x, y = major * F, minor - F + 1
                if buf:                     # flush the staged run so far
                    I[flush_at:flush_at + len(buf)] = \
                        np.frombuffer(buf, dtype=np.uint8)
                    buf = bytearray()
                    ba = buf.append
                I[tb + nx:tb + tail_cap] = 0    # line 11: null-close
                new_z = z + 1
                new_size = B if const else self.block_size_at(new_z)
                slots = self._slots_for(new_size)
                self._ensure_capacity(slots)
                I = self.I                  # may have been reallocated
                new_ptr = self.nblocks
                self.nblocks += slots
                nb = new_ptr * B
                self._set_u32(nb + _OFF_NPTR, d)        # line 12
                self._set_u32(tb + _OFF_NPTR, new_ptr)  # line 13
                self.set_z(hb, new_z)
                t_ptr, tb, z = new_ptr, nb, new_z
                tail_cap = new_size
                nx = H
                flush_at = tb + H
                t_dnum = d
                before = len(buf)           # line 16/17: recoded emit
                while x >= 0x80:
                    ba(0x80 | (x & 0x7F))
                    x >>= 7
                ba(x)
                if y:
                    while y >= 0x80:
                        ba(0x80 | (y & 0x7F))
                        y >>= 7
                    ba(y)
                nx += len(buf) - before     # b-gap code length differs
                last_d = d
                ft += 1
                continue
            if ft == 0:
                # first posting ever: head slot 0 doubles as d_num
                self._set_u32(hb + _OFF_NPTR, d)
                t_dnum = d
            while x >= 0x80:                # line 17: stage the code bytes
                ba(0x80 | (x & 0x7F))
                x >>= 7
            ba(x)
            if y:
                while y >= 0x80:
                    ba(0x80 | (y & 0x7F))
                    y >>= 7
                ba(y)
            nx += nbytes                # line 18 (staged)
            last_d = d
            ft += 1                     # line 20
        if buf:
            I[flush_at:flush_at + len(buf)] = \
                np.frombuffer(buf, dtype=np.uint8)
        # one slice view writes t_ptr / last_d / ft back (line 13/19/20)
        I[hb + 4:hb + 16].view(np.uint32)[:] = (t_ptr, last_d, ft)
        I[hb + 16] = nx & 0xFF          # line 18
        if not const:
            I[hb + 17] = (nx >> 8) & 0xFF

    # ------------------------------------------------------------------
    # chain traversal / decoding (§3.6)
    # ------------------------------------------------------------------

    def chain_slots(self, h_ptr: int):
        """Yield (slot_ptr, z, is_tail) for every block in a term's chain."""
        hb = self._slot_base(h_ptr)
        t_ptr = self.get_tptr(hb)
        ptr, z = h_ptr, 1
        while True:
            if ptr == t_ptr:
                yield ptr, z, True
                return
            yield ptr, z, False
            ptr = self._get_u32(self._slot_base(ptr) + _OFF_NPTR)
            z += 1

    def decode_postings(self, h_ptr: int):
        """Decode a term's full postings list.

        Returns (docids, seconds) as int64 arrays; for doc-level ``seconds``
        is f_{t,i}; for word-level it is the w-gap payload (callers rebuild
        absolute word positions per document if needed).
        """
        B, F = self.B, self.F
        hb = self._slot_base(h_ptr)
        nx = self.get_nx(hb)
        docids: list[int] = []
        seconds: list[int] = []
        prev_block_first_d = 0
        cur_d = 0
        for ptr, z, is_tail in self.chain_slots(h_ptr):
            base = self._slot_base(ptr)
            if ptr == h_ptr:
                start = self.head_fixed + int(self.I[base + self.head_fixed - 1])
            else:
                start = H
            cap = self.block_size_at(z) if not self.const_mode else B
            end = (base + nx) if is_tail else (base + cap)
            pos = base + start
            first_in_block = True
            while pos < end:
                if self.I[pos] == 0:  # null sentinel: rest of block unused
                    break
                (major, minor), pos = dvbyte_decode_from(self.I, pos, F)
                if self.word_level:
                    # encode order was (major=w_payload, minor=g_stored)
                    w_payload, g_stored = major, minor
                    if first_in_block and ptr != h_ptr:
                        cur_d = prev_block_first_d + (g_stored - 1)
                    else:
                        cur_d = cur_d + (g_stored - 1)
                    seconds.append(w_payload)
                else:
                    g = major
                    if first_in_block and ptr != h_ptr:
                        cur_d = prev_block_first_d + g  # b-gap
                    else:
                        cur_d = cur_d + g
                    seconds.append(minor)
                docids.append(cur_d)
                if first_in_block:
                    prev_block_first_d = cur_d
                    first_in_block = False
        return (np.asarray(docids, dtype=np.int64),
                np.asarray(seconds, dtype=np.int64))

    # ------------------------------------------------------------------
    # space accounting (Table 7)
    # ------------------------------------------------------------------

    def used_bytes(self) -> int:
        return self.nblocks * self.B

    def component_breakdown(self, head_ptrs) -> dict:
        """Byte-accurate Table 7 component analysis over all chains."""
        B = self.B
        stats = {
            "head_blocks": 0, "head_link": 0, "head_vocab": 0,
            "head_postings": 0, "head_nulls": 0,
            "full_blocks": 0, "full_link": 0, "full_postings": 0,
            "full_nulls": 0,
            "tail_blocks": 0, "tail_docnum": 0, "tail_postings": 0,
            "tail_unused": 0,
        }
        for h_ptr in head_ptrs:
            hb = self._slot_base(h_ptr)
            nx = self.get_nx(hb)
            tlen = int(self.I[hb + self.head_fixed - 1])
            single = self.get_tptr(hb) == h_ptr
            for ptr, z, is_tail in self.chain_slots(h_ptr):
                base = self._slot_base(ptr)
                cap = self.block_size_at(z) if not self.const_mode else B
                if ptr == h_ptr:
                    stats["head_blocks"] += 1
                    stats["head_link"] += 2 * H  # n_ptr + t_ptr
                    stats["head_vocab"] += (self.head_fixed - 2 * H) + tlen
                    start = self.head_fixed + tlen
                    if is_tail:
                        stats["head_postings"] += nx - start
                        stats["head_nulls"] += cap - nx
                    else:
                        data_end = self._data_end(base + start, base + cap)
                        stats["head_postings"] += data_end - (base + start)
                        stats["head_nulls"] += (base + cap) - data_end
                elif is_tail and not single:
                    stats["tail_blocks"] += 1
                    stats["tail_docnum"] += H
                    stats["tail_postings"] += nx - H
                    stats["tail_unused"] += cap - nx
                else:
                    stats["full_blocks"] += 1
                    stats["full_link"] += H
                    data_end = self._data_end(base + H, base + cap)
                    stats["full_postings"] += data_end - (base + H)
                    stats["full_nulls"] += (base + cap) - data_end
        return stats

    def _data_end(self, start: int, end: int) -> int:
        seg = self.I[start:end]
        nz = np.flatnonzero(seg)
        return start + (int(nz[-1]) + 1 if len(nz) else 0)
