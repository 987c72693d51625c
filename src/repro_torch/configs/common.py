"""The LM family's serving shapes and architecture record.

Ported from the LM part of the JAX package's ``src/repro/configs/
common.py``: :data:`LM_SHAPES` and :class:`LMArch` with its analytic
``flops``.  The reference's ``LMArch.build``, which lowers a JAX ``Cell``
with shardings for its HLO dry-run, is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.lm import LMConfig

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclass
class LMArch:
    arch_id: str
    cfg: LMConfig
    family: str = "lm"
    shapes: tuple = tuple(LM_SHAPES)

    def flops(self, shape_id: str) -> float:
        s = LM_SHAPES[shape_id]
        cfg = self.cfg
        n_act = cfg.active_params_count
        if s["kind"] == "train":
            toks = s["seq"] * s["batch"]
            return 6.0 * n_act * toks
        if s["kind"] == "prefill":
            toks = s["seq"] * s["batch"]
            attn = (4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                    * s["seq"] * toks / 2)  # causal half
            return 2.0 * n_act * toks + attn
        # decode: one token per sequence against a seq-long cache
        toks = s["batch"]
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * s["seq"] * toks
        return 2.0 * n_act * toks + attn
