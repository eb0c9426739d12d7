"""A BERT encoder of the port's own, for the sentence-similarity metric
(`evaluate/metrics.py:Similarity`), computing what `transformers.BertModel`
with eager attention computes: word + position + token-type embeddings and
a LayerNorm (eps from `config.json`), then per layer the self-attention
(scores q.k / sqrt(d) plus the extended mask (1 - mask) * the dtype's
lowest value, softmax), its output projection and residual LayerNorm, the
exact erf GELU feed-forward and its residual LayerNorm; it returns every
hidden state (the embeddings' and each layer's). No dropout: evaluation
only.

`load_bert(directory)` reads a local Hugging Face directory: `config.json`
and the weights, `model.safetensors` (parsed here: an 8-byte little-endian
header length, a JSON header of dtype, shape and byte offsets, then the
raw bytes; F32, F16, BF16) or `pytorch_model.bin` (`torch.load(...,
weights_only=True)`). Keys may carry the `bert.` prefix; the pooler and
any pre-training heads are ignored. `write_safetensors` writes the same
format.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import struct
from dataclasses import dataclass
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

# the weights' dtypes, and I64 for the position-id buffer older
# checkpoints hold (left out when loading)
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16, "I64": torch.int64}


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"

    @classmethod
    def from_json(cls, path: str) -> "BertConfig":
        with open(path) as f:
            blob = json.load(f)
        cfg = cls(**{k: blob[k] for k in cls.__dataclass_fields__
                     if k in blob})
        if cfg.hidden_act != "gelu":
            raise ValueError(f"{path}: hidden_act {cfg.hidden_act!r}; the "
                             f"port's BERT computes the exact erf 'gelu'")
        if blob.get("position_embedding_type", "absolute") != "absolute":
            raise ValueError(f"{path}: only absolute position embeddings")
        return cfg

    def to_json(self) -> dict:
        return {"model_type": "bert", "architectures": ["BertModel"],
                "hidden_dropout_prob": 0.1,
                "attention_probs_dropout_prob": 0.1, "pad_token_id": 0,
                "position_embedding_type": "absolute",
                **{k: getattr(self, k) for k in self.__dataclass_fields__}}


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size,
                                      eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) \
            + self.token_type_embeddings(token_type_ids)
        x = x + self.position_embeddings(positions)[None]
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)

    def forward(self, x, mask_bias):
        b, n, d = x.shape

        def split(t):
            return t.view(b, n, self.heads, -1).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(
            self.value(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) \
            / math.sqrt(d // self.heads) + mask_bias
        ctx = torch.matmul(torch.softmax(scores, dim=-1), v)
        return ctx.transpose(1, 2).reshape(b, n, d)


class _DenseNorm(nn.Module):
    """dense, then LayerNorm(dense output + residual)."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = _SelfAttention(cfg)
        self.output = _DenseNorm(cfg.hidden_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, mask_bias):
        return self.output(self.self(x, mask_bias), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class _Layer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                 cfg.layer_norm_eps)

    def forward(self, x, mask_bias):
        a = self.attention(x, mask_bias)
        return self.output(self.intermediate(a), a)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class BertEncoder(nn.Module):
    """Module names follow the Hugging Face state_dict, so a checkpoint's
    tensors load by name."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, input_ids, attention_mask=None,
                token_type_ids=None) -> List[torch.Tensor]:
        """input_ids (B, N) -> the num_hidden_layers + 1 hidden states,
        each (B, N, hidden)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        dtype = x.dtype
        mask_bias = ((1.0 - attention_mask[:, None, None, :].to(dtype))
                     * torch.finfo(dtype).min)
        hidden = [x]
        for layer in self.encoder.layer:
            x = layer(x, mask_bias)
            hidden.append(x)
        return hidden


@contextlib.contextmanager
def exact_f32_matmuls():
    """f32 matmuls at full precision (no TF32) inside the block, so the
    card's BERT can be held to the CPU's."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        t = (torch.frombuffer(data, dtype=dtype, count=(end - begin)
                              // dtype.itemsize, offset=begin)
             if end > begin else torch.zeros(0, dtype=dtype))
        out[name] = t.reshape(info["shape"]).clone()
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write CPU tensors (dtypes of SAFETENSORS_DTYPES) as `.safetensors`:
    the header padded with spaces to 8 bytes, the data in key order."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def _model_keys(raw: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors under the module's names: the `bert.` prefix
    dropped, old LayerNorm names (gamma, beta) renamed, the pooler, the
    pre-training heads and the position-id buffers left out."""
    out = {}
    for name, t in raw.items():
        if name.startswith("bert."):
            name = name[len("bert."):]
        if not name.startswith(("embeddings.", "encoder.")) \
                or name.endswith("position_ids") \
                or name.endswith("token_type_ids"):
            continue
        name = name.replace("LayerNorm.gamma", "LayerNorm.weight") \
            .replace("LayerNorm.beta", "LayerNorm.bias")
        out[name] = t
    return out


def load_bert(directory: str, device="cpu") -> BertEncoder:
    """The BERT of a local Hugging Face directory, f32 on `device`, in eval
    mode, its parameters frozen. Raises FileNotFoundError when the directory lacks config.json or
    the weights."""
    config = os.path.join(directory, "config.json")
    if not os.path.isfile(config):
        raise FileNotFoundError(f"{config} not found")
    st = os.path.join(directory, "model.safetensors")
    pt = os.path.join(directory, "pytorch_model.bin")
    if os.path.isfile(st):
        raw = read_safetensors(st)
    elif os.path.isfile(pt):
        raw = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{directory}: no model.safetensors or "
                                f"pytorch_model.bin")
    model = BertEncoder(BertConfig.from_json(config))
    state = {k: v.to(torch.float32) for k, v in _model_keys(raw).items()}
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False).to(device).eval()
