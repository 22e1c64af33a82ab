"""Encoder/Decoder — model-specific format adaptation; port of
``repro.core.codec``.

The paper's Encoder/Decoder component translates the Manager's standard
feature frame into the format a deployed model takes, and decodes the
model's decisions back. Three encoder families, computing what the
reference's compute:
  * ``VectorCodec``  — the z-scored feature vector, clipped (classic RL
    policies);
  * ``TokenCodec``   — features binned into LM tokens, feature j into its
    own range of ``bins`` tokens after ``offset`` specials;
  * ``EmbeddingCodec`` — features projected into (E, n_frames, d_model)
    frame embeddings by a fixed random matrix; input only.

The reference draws ``EmbeddingCodec``'s projection from a JAX key. Torch
cannot reproduce that draw, so the port takes the matrix as a numpy array
(``proj=``; the tests feed both packages the reference's), and without
one draws its own from ``torch.Generator().manual_seed(seed)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import normalize as nz


@dataclass(frozen=True)
class VectorCodec:
    n_features: int
    clip: float = 8.0

    def encode(self, state: nz.NormState, features):
        z = nz.znorm(state, features[:, :, None])[..., 0]
        return torch.clamp(z, -self.clip, self.clip)

    def decode(self, state: nz.NormState, outputs, low, high):
        """The model emits z-scored setpoints; decode to engineering
        units, clipped into [low, high]."""
        raw = nz.denorm_z(state, outputs[:, :, None])[..., 0]
        return torch.clamp(raw, low, high)


@dataclass(frozen=True)
class TokenCodec:
    """Features binned into LM tokens: feature j maps into the token range
    [offset + j*bins, offset + (j+1)*bins), so one vocabulary serves all
    features (15 features x 128 bins + 3 specials fit musicgen's 2048)."""
    n_features: int
    bins: int = 128
    offset: int = 3          # 0=pad 1=bos 2=sep
    clip: float = 4.0

    @property
    def vocab_needed(self):
        return self.offset + self.n_features * self.bins

    def encode(self, state: nz.NormState, features):
        z = nz.znorm(state, features[:, :, None])[..., 0]
        u = (torch.clamp(z, -self.clip, self.clip) + self.clip) \
            / (2 * self.clip)
        b = torch.clamp((u * self.bins).to(torch.int32), max=self.bins - 1)
        base = torch.arange(self.n_features, dtype=torch.int32,
                            device=b.device) * self.bins
        return self.offset + base + b

    def decode(self, state: nz.NormState, tokens, low, high):
        base = torch.arange(tokens.shape[-1], dtype=tokens.dtype,
                            device=tokens.device) * self.bins
        rel = tokens - self.offset - base
        u = (torch.clamp(rel, 0, self.bins - 1).to(torch.float32) + 0.5) \
            / self.bins
        z = u * 2 * self.clip - self.clip
        raw = nz.denorm_z(state, z[:, :, None])[..., 0]
        return torch.clamp(raw, low, high)


@dataclass(frozen=True, eq=False)
class EmbeddingCodec:
    """Features -> (E, n_frames, d_model) embeddings through a fixed
    (n_features, n_frames * d_model) projection, scaled by
    1/sqrt(n_features) (the modality-frontend stub contract)."""
    n_features: int
    d_model: int
    n_frames: int = 1
    seed: int = 0
    proj: Optional[np.ndarray] = None   # the matrix, already scaled

    def _proj(self, device):
        shape = (self.n_features, self.n_frames * self.d_model)
        if self.proj is not None:
            p = torch.from_numpy(np.array(self.proj, np.float32))
            if tuple(p.shape) != shape:
                raise ValueError(f"EmbeddingCodec: proj {tuple(p.shape)}, "
                                 f"expected {shape}")
            return p.to(device)
        g = torch.Generator().manual_seed(self.seed)
        return (torch.randn(shape, generator=g)
                / math.sqrt(self.n_features)).to(device)

    def encode(self, state: nz.NormState, features):
        z = torch.clamp(nz.znorm(state, features[:, :, None])[..., 0],
                        -8, 8)
        e = z @ self._proj(z.device)
        return e.reshape(features.shape[0], self.n_frames, self.d_model)

    def decode(self, state, outputs, low, high):
        raise NotImplementedError(
            "embedding codec is input-only (stub frontend)")
