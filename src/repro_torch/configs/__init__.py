"""Model configurations of the port, and the architecture registry:
``get_arch(<id>)`` resolves the JAX package's ids and aliases
(``src/repro/configs/__init__.py``) for the architectures the port has.

Every id resolves to its ``ARCH``: the five LM configurations, schnet,
the four recsys ones (dlrm-mlperf, sasrec, din, two-tower-retrieval) and
``paper_index``.  An id the port lacked would raise a ``KeyError`` that
says it is not ported yet; none is left.
"""

from importlib import import_module

ARCH_IDS = [
    "llama4_scout_17b_a16e",
    "granite_moe_3b_a800m",
    "granite_3_2b",
    "llama3_2_3b",
    "mistral_large_123b",
    "schnet",
    "dlrm_mlperf",
    "sasrec",
    "din",
    "two_tower_retrieval",
    "paper_index",
]

ALIASES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "granite-3-2b": "granite_3_2b",
    "llama3.2-3b": "llama3_2_3b",
    "mistral-large-123b": "mistral_large_123b",
    "dlrm-mlperf": "dlrm_mlperf",
    "two-tower-retrieval": "two_tower_retrieval",
}

#: the ids whose ``ARCH`` the port has
PORTED = frozenset({
    "llama4_scout_17b_a16e",
    "granite_moe_3b_a800m",
    "granite_3_2b",
    "llama3_2_3b",
    "mistral_large_123b",
    "schnet",
    "dlrm_mlperf",
    "sasrec",
    "din",
    "two_tower_retrieval",
    "paper_index",
})


def get_arch(arch_id: str):
    mod_name = ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if mod_name not in PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{sorted(PORTED)}")
    return import_module(f"{__name__}.{mod_name}").ARCH
