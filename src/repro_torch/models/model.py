"""Model facade (``repro/models/model.py``): one API over every assigned
family: dense, MoE, MLA, the Jamba hybrid, xLSTM, the VLM (M-RoPE) and
the encoder-decoder (whisper).

  build_model(cfg, device=None, **kw)  ->  Model with
    .init(seed_or_key)                params (float32 master), installed
    .load_params(tree)                install a parameter tree (a copy)
    .use_params(tree)                 adopt a tree's tensors (no copy)
    .hidden_seq(batch, params=, remat=)  (B, S, D) final hidden
    .unembed(params=)                 the (V, D) output matrix
    .logits_seq(batch)                (B, S, V)
    .prefill(batch, cache_len)        (last-token logits (B, V), caches)
    .decode(tokens, pos, caches)      ((B, 1, V) logits, caches)
    .init_cache(batch, cache_len, dtype)

The model holds its parameters (an ``nn.Module`` whose submodules follow
the reference's tree: ``weights.layers.pos0.attn.wq``), so the methods
take no ``params`` argument. ``batch`` is a dict with the reference's
keys, numpy arrays or tensors:

  dense / moe / hybrid / ssm : tokens (B, S) ints
  vlm                        : embeds (B, S, D) + positions (3, B, S) ints
  audio (enc-dec)            : frames (B, enc_seq, D) + tokens (B, S) ints

Decode embeds text tokens in every family; it writes the new cache row
in place and returns the same cache tensors; ``pos`` is a Python int,
the token's cache index, which is also its position (on all three M-RoPE
streams, as in the reference).

The compute dtype is ``cfg.dtype`` (bfloat16 for the assigned configs).
The reference casts each float32 weight to it at each use. Serving
(``prefill``, ``decode``, ``hidden_seq`` without ``params``) uses one
cast copy (``compute_params``), made on first use after the weights
change: the same bits, without reading the float32 weights and writing a
fresh copy on every step. The leaves the reference reads in float32 stay
float32 (``transformer.cast_tree``: norm scales, LayerNorms' scales and
biases, ``_FLOAT32_LEAVES``). A model whose float32 masters
and a cast copy do not fit on the card together takes
``cast_at_use=True``: serving then casts each block's masters at its use
and holds no copy.
Training passes the float32 masters as ``params``: ``hidden_seq`` then
casts them inside the autograd graph at each block, as the reference
does, so the gradients land on the float32 leaves (``training/``); an
optimizer update installs its new tensors with ``use_params``, which
drops the cast copy.

Runs on ``cuda:0`` unless the caller passes ``device``; with no card and
no ``device`` it raises.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import _tree_flatten_with_names
from repro_torch.core import prng
from repro_torch.core.solver import _device

from . import encdec
from . import transformer as tfm
from .common import compute_dtype


def _module(tree: dict) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
    return m


def _tree(m: nn.Module) -> dict:
    out: dict[str, Any] = dict(m.named_parameters(recurse=False))
    out.update({k: _tree(c) for k, c in m.named_children()})
    return out


def _flat(tree: dict) -> dict:
    """{leaf path: leaf}, paths as the reference's flattener names them."""
    names, leaves, _ = _tree_flatten_with_names(tree)
    return dict(zip(names, leaves))


def _detached(tree: dict) -> dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def _init_tree(key, cfg) -> dict:
    if cfg.enc_dec:
        return encdec.init_encdec(key, cfg)
    return tfm.init_decoder(key, cfg)


def param_shapes(cfg) -> dict:
    """{leaf path: shape} of the model's parameters, named as the
    reference's ``tree_flatten_with_path`` joined by "/" (drawn on the
    meta device: shapes only; a few seconds at full size, so kept a
    config)."""
    return dict(_param_shapes(cfg))


@functools.lru_cache(maxsize=None)
def _param_shapes(cfg) -> dict:
    tree = _init_tree(prng.PRNGKey(0, device="meta"), cfg)
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


class Model(nn.Module):
    def __init__(self, cfg, device=None, *, q_chunk: int = 1024,
                 kv_chunk: int = 1024, ssm_chunk: int = 256,
                 skip_masked_blocks: bool = False,
                 remat_policy: str = "nothing", cast_at_use: bool = False):
        super().__init__()
        if remat_policy not in tfm.REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{tfm.REMAT_POLICIES}")
        self.cfg = cfg
        self.device = _device(device, "the model")
        self.q_chunk, self.kv_chunk = q_chunk, kv_chunk
        self.ssm_chunk = ssm_chunk
        self.skip_masked_blocks = skip_masked_blocks
        self.cast_at_use = cast_at_use
        self.remat_policy = remat_policy
        self.weights: nn.Module | None = None
        self._compute: dict | None = None
        # float32 products stay float32 (TF32 keeps ~3 decimal digits);
        # both flags are process-wide in PyTorch.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------- params
    def init(self, seed_or_key=0) -> dict:
        """Draw the reference's parameters for this seed (an int) or key
        (a (2,) key of ``core.prng``), install them and return them."""
        if isinstance(seed_or_key, int):
            key = prng.PRNGKey(seed_or_key, device=self.device)
        else:
            key = seed_or_key.to(self.device)
        self.load_params(_init_tree(key, self.cfg))
        return self.params

    def load_params(self, tree: dict) -> None:
        """Install a parameter tree (the reference's structure, float32)."""
        want, got = param_shapes(self.cfg), _flat(tree)
        if set(want) != set(got):
            missing, extra = set(want) - set(got), set(got) - set(want)
            raise ValueError(f"parameter names differ: missing "
                             f"{sorted(missing)}, unexpected {sorted(extra)}")
        bad = [k for k in want if tuple(got[k].shape) != want[k]]
        if bad:
            raise ValueError(f"parameter shapes differ at {bad}")

        def place(t):
            if isinstance(t, dict):
                return {k: place(v) for k, v in t.items()}
            return torch.as_tensor(t).to(self.device, torch.float32)
        self.use_params(place(tree))

    def use_params(self, tree: dict) -> None:
        """Adopt the tensors of a parameter tree (float32, on the model's
        device, the reference's structure) as the model's parameters,
        without a copy; the cast copy is made again on its next use."""
        self.weights = _module(tree)
        self._compute = None

    @property
    def params(self) -> dict:
        """The float32 master parameters, the reference's tree."""
        if self.weights is None:
            raise RuntimeError("no parameters: call init or load_params")
        return _tree(self.weights)

    @property
    def compute_params(self) -> dict:
        """The parameters in the compute dtype (the float32 leaves left
        float32); under ``cast_at_use`` the float32 masters themselves."""
        if self.cast_at_use:
            return self.params
        if self._compute is None:
            self._compute = tfm.cast_tree(_detached(self.params),
                                          compute_dtype(self.cfg))
        return self._compute

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------- embed
    def _params(self, params):
        return self.compute_params if params is None else params

    def _embed_in(self, batch, dtype, params=None):
        """The input states and their positions: the VLM's ``embeds`` and
        (3, B, S) ``positions``, else the embedded ``tokens`` and
        0 .. S - 1."""
        if self.cfg.family == "vlm":
            h = torch.as_tensor(batch["embeds"]).to(self.device).to(dtype)
            positions = torch.as_tensor(batch["positions"]).to(
                self.device, torch.long)
            return h, positions
        h = self._embed_tokens(batch["tokens"], dtype, params)
        B, S = h.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        return h, positions

    def _embed_tokens(self, tokens, dtype, params=None):
        tokens = torch.as_tensor(tokens).to(self.device, torch.long)
        return tfm.embed_tokens(self.cfg, self._params(params), tokens, dtype)

    def _memory(self, batch, dtype, params, cast):
        """The encoder's output for the batch's ``frames``."""
        frames = torch.as_tensor(batch["frames"]).to(self.device).to(dtype)
        return encdec.encode(self.cfg, self._params(params), frames,
                             cast=cast)

    def _chunks(self) -> dict:
        return dict(q_chunk=self.q_chunk, kv_chunk=self.kv_chunk,
                    ssm_chunk=self.ssm_chunk,
                    skip_masked_blocks=self.skip_masked_blocks)

    def _serve_cast(self):
        """The cast serving applies at each block's use (None: the
        weights are the cast copy already)."""
        return compute_dtype(self.cfg) if self.cast_at_use else None

    # ---------------------------------------------------------- sequence
    def hidden_seq(self, batch, *, params: dict | None = None,
                   remat: bool = False) -> torch.Tensor:
        """The final hidden states. Without ``params`` the model's own
        weights (the cast copy); with ``params`` (float32 masters, the
        reference's tree) the training forward: cast inside the graph,
        each period (each decoder block of the encoder-decoder)
        checkpointed under ``remat`` by ``remat_policy`` (the
        encoder-decoder's by 'nothing', as the reference's)."""
        dtype = compute_dtype(self.cfg)
        cast = self._serve_cast() if params is None else dtype
        if self.cfg.enc_dec:
            memory = self._memory(batch, dtype, params, cast)
            tok = self._embed_tokens(batch["tokens"], dtype, params)
            return encdec.decode_seq(self.cfg, self._params(params), tok,
                                     memory, remat=remat and params is not None,
                                     q_chunk=self.q_chunk,
                                     kv_chunk=self.kv_chunk, cast=cast)
        h, positions = self._embed_in(batch, dtype, params)
        if params is None:
            return tfm.forward_seq(self.cfg, self.compute_params, h,
                                   positions, cast=cast, **self._chunks())
        return tfm.forward_seq(self.cfg, params, h, positions, remat=remat,
                               remat_policy=self.remat_policy, cast=cast,
                               **self._chunks())

    def unembed(self, params: dict | None = None) -> torch.Tensor:
        """The float32 (V, D) output matrix (the tied table where tied)."""
        return tfm.unembed_matrix(self.cfg, self.params if params is None
                                  else params)

    def _unembed_c(self) -> torch.Tensor:
        return tfm.unembed_matrix(self.cfg, self.compute_params).to(
            compute_dtype(self.cfg))

    def logits_seq(self, batch) -> torch.Tensor:
        h = self.hidden_seq(batch)
        return h @ self._unembed_c().T

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16):
        if self.cfg.enc_dec:
            return encdec.init_dec_cache(self.cfg, batch, cache_len, dtype,
                                         self.device)
        return tfm.init_cache(self.cfg, batch, cache_len, dtype, self.device)

    def prefill(self, batch, cache_len: int):
        dtype, cast = compute_dtype(self.cfg), self._serve_cast()
        if self.cfg.enc_dec:
            memory = self._memory(batch, dtype, None, cast)
            tok = self._embed_tokens(batch["tokens"], dtype)
            h, caches = encdec.prefill(self.cfg, self.compute_params, tok,
                                       memory, cache_len,
                                       q_chunk=self.q_chunk,
                                       kv_chunk=self.kv_chunk, cast=cast)
        else:
            h, positions = self._embed_in(batch, dtype)
            h, caches = tfm.forward_prefill(self.cfg, self.compute_params,
                                            h, positions, cache_len,
                                            cast=cast, **self._chunks())
        logits = h[:, -1, :] @ self._unembed_c().T
        return logits, caches

    def decode(self, tokens, pos: int, caches):
        """tokens: (B, 1) ints; pos: the index the tokens take."""
        h = self._embed_tokens(tokens, compute_dtype(self.cfg))
        step = encdec.decode_step if self.cfg.enc_dec else tfm.forward_decode
        h, caches = step(self.cfg, self.compute_params, h, int(pos), caches,
                         cast=self._serve_cast())
        return h @ self._unembed_c().T, caches


def build_model(cfg, device=None, **kw) -> Model:
    return Model(cfg, device, **kw)
