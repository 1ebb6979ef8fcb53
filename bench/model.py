"""A model configuration as the benchmark holds it: the published keys
of ``bench/configs/<name>.json`` and the program's settings beside them,
read into :class:`Dims`, the sizes that the weights, the reference and
the frozen formulas use.  Nothing here imports the program."""

from __future__ import annotations

from dataclasses import dataclass, field, fields

__all__ = ["Dims", "dims", "PUBLISHED_TO_DIMS"]

#: the published configuration's keys (Hugging Face ``config.json``
#: names) and the sizes they set
PUBLISHED_TO_DIMS = {
    "hidden_size": "d_model",
    "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "kv_heads",
    "head_dim": "head_dim",
    "head_size": "head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab",
    "num_local_experts": "n_experts",
    "num_experts_per_tok": "top_k",
    "rope_theta": "rope_theta",
    "sliding_window": "window",
    "rms_norm_eps": "norm_eps",
    "layer_norm_epsilon": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
}


@dataclass(frozen=True)
class Dims:
    """The sizes of one configuration, with the layer kind of every
    layer: ``moe`` (attention and a mixture of experts) or ``rwkv``."""

    family: str
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    kind: str
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_seq_chunk: int = 512
    rope_theta: float = 10_000.0
    window: int | None = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    #: the program's own settings, passed to it unchanged
    program: dict = field(default_factory=dict)

    def padded_vocab(self, multiple: int = 128) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple

    def param_count(self) -> tuple[int, int]:
        """(total, active per token) of the weights the benchmark draws
        (``bench/reference/<family>.py``): a token meets ``top_k`` of
        each layer's ``n_experts`` experts."""
        import importlib
        import math
        ref = importlib.import_module(f"bench.reference.{self.family}")
        total = active = 0
        for group in ref.groups(self):
            for leaf in group:
                n = math.prod(leaf.shape)
                total += n
                if leaf.name.rsplit(".", 1)[-1] in ("w1", "w2", "w3") \
                        and ".moe." in leaf.name:
                    n = n * self.top_k // self.n_experts
                active += n
        return total, active


def dims(config: dict, **overrides) -> Dims:
    """The :class:`Dims` of a configuration file's contents; keyword
    arguments replace published keys (as the tests' small sizes do)."""
    config = {**config, **overrides}
    kw = {"family": config["family"], "kind": config["layer_kind"],
          "dtype": config.get("torch_dtype", "bfloat16"),
          "program": dict(config.get("program", {}))}
    names = {f.name for f in fields(Dims)}
    for key, name in PUBLISHED_TO_DIMS.items():
        if key in config:
            kw[name] = config[key]
    for key, value in config.get("program", {}).items():
        if key in names:
            kw[key] = value
    if "head_dim" not in kw:
        kw["head_dim"] = kw["d_model"] // max(kw.get("n_heads", 1), 1)
    kw.setdefault("n_heads", kw["d_model"] // kw["head_dim"])
    kw.setdefault("kv_heads", 0)
    return Dims(**kw)
