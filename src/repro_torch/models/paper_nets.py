"""The paper's own model classes (§4.2), batched over clients (the
counterpart of ``repro.models.paper_nets``).

  logreg : logistic regression (synthetic 60-d / MNIST 784-d)
  cnn    : 2-layer CNN, hidden 64 (FEMNIST)
  lstm   : 1-layer LSTM, hidden 256, char classes 80 (Shakespeare)

Parameters are plain dicts of tensors in the JAX package's layouts: the CNN
keeps HWIO kernels and NHWC inputs (permuted only at the ``F.conv2d``
call), the LSTM its i, f, g, o gate order. The ``*_batched`` functions run
P client models at once — leaves [P, ...], inputs [P, B, ...] — the way the
JAX engine vmaps one client's function: the P CNNs become one grouped
convolution (``groups=P``), the dense layers batched matmuls. The
unbatched functions are the P = 1 case.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import PaperNetConfig
from repro_torch.models.layers import dense_init, embed_init


def init_paper_net(gen: torch.Generator, cfg: PaperNetConfig,
                   dtype=torch.float32, device="cpu") -> Dict:
    """One model's params from a CPU generator, moved to ``device``."""
    if cfg.kind == "logreg":
        p = {"w": torch.zeros((cfg.input_dim, cfg.num_classes), dtype=dtype),
             "b": torch.zeros((cfg.num_classes,), dtype=dtype)}
    elif cfg.kind == "cnn":
        h = cfg.hidden
        flat = (cfg.image_size // 4) ** 2 * h
        p = {
            "conv1": dense_init(gen, 25 * cfg.channels,
                                (5, 5, cfg.channels, h // 2), dtype),
            "b1": torch.zeros((h // 2,), dtype=dtype),
            "conv2": dense_init(gen, 25 * h // 2, (5, 5, h // 2, h), dtype),
            "b2": torch.zeros((h,), dtype=dtype),
            "fc": dense_init(gen, flat, (flat, cfg.num_classes), dtype),
            "bf": torch.zeros((cfg.num_classes,), dtype=dtype),
        }
    elif cfg.kind == "lstm":
        h, e = cfg.hidden, cfg.embed_dim
        p = {
            "embed": embed_init(gen, (cfg.vocab, e), dtype),
            "wx": dense_init(gen, e, (e, 4 * h), dtype),
            "wh": dense_init(gen, h, (h, 4 * h), dtype),
            "bh": torch.zeros((4 * h,), dtype=dtype),
            "fc": dense_init(gen, h, (h, cfg.num_classes), dtype),
            "bf": torch.zeros((cfg.num_classes,), dtype=dtype),
        }
    else:
        raise ValueError(cfg.kind)
    return {k: v.to(device) for k, v in p.items()}


# ---------------------------------------------------------------------------
# batched forward: P client models at once
# ---------------------------------------------------------------------------

def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    P: int) -> torch.Tensor:
    """x [B, P*Cin, H, W] (client-major channels); w [P, 5, 5, Cin, Cout]
    HWIO per client; b [P, Cout] -> [B, P*Cout, H/2, W/2]: SAME 5x5
    convolution + bias, ReLU, VALID 2x2 max pool."""
    _, k, _, cin, cout = w.shape
    wt = w.permute(0, 4, 3, 1, 2).reshape(P * cout, cin, k, k)
    y = F.conv2d(x, wt, b.reshape(P * cout), padding=(k - 1) // 2, groups=P)
    return F.max_pool2d(F.relu(y), 2)


def paper_net_forward_batched(params: Dict, x: torch.Tensor,
                              cfg: PaperNetConfig) -> torch.Tensor:
    """params leaves [P, ...]; x: logreg [P, B, D] float, cnn
    [P, B, H, W, C] float, lstm [P, B, T] int -> logits [P, B, classes]."""
    if cfg.kind == "logreg":
        return torch.bmm(x, params["w"]) + params["b"][:, None]
    if cfg.kind == "cnn":
        P, B, H, W, C = x.shape
        y = x.permute(1, 0, 4, 2, 3).reshape(B, P * C, H, W)
        y = _conv_relu_pool(y, params["conv1"], params["b1"], P)
        y = _conv_relu_pool(y, params["conv2"], params["b2"], P)
        _, _, h, w = y.shape
        # back to NHWC before flattening, the order of the HWIO fc rows
        y = (y.reshape(B, P, -1, h, w).permute(1, 0, 3, 4, 2)
             .reshape(P, B, -1))
        return torch.bmm(y, params["fc"]) + params["bf"][:, None]
    if cfg.kind == "lstm":
        P, B, T = x.shape
        rows = torch.arange(P, device=x.device)[:, None, None]
        e = params["embed"][rows, x.long()]                   # [P, B, T, e]
        h = e.new_zeros((P, B, cfg.hidden))
        c = e.new_zeros((P, B, cfg.hidden))
        for t in range(T):
            gates = (torch.bmm(e[:, :, t], params["wx"])
                     + torch.bmm(h, params["wh"]) + params["bh"][:, None])
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return torch.bmm(h, params["fc"]) + params["bf"][:, None]
    raise ValueError(cfg.kind)


def _masked_mean(v: torch.Tensor, mask) -> torch.Tensor:
    """Mean over the last axis; with a mask, sum(v*m) / max(sum(m), 1)."""
    if mask is None:
        return v.mean(dim=-1)
    m = mask.to(torch.float32)
    return (v * m).sum(dim=-1) / torch.clamp_min(m.sum(dim=-1), 1.0)


def paper_net_loss_batched(params: Dict, batch: Dict,
                           cfg: PaperNetConfig) -> torch.Tensor:
    """batch: {"x": [P, B, ...], "y": [P, B] int, "mask": [P, B] 0/1}
    -> [P] per-client masked-mean cross entropy (log-softmax in f32)."""
    logits = paper_net_forward_batched(params, batch["x"], cfg)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(-1, batch["y"].long()[..., None])[..., 0]
    return _masked_mean(nll, batch.get("mask"))


def paper_net_correct(params: Dict, batch: Dict,
                      cfg: PaperNetConfig) -> torch.Tensor:
    """-> [P, B] f32, 1 where the argmax prediction equals the label."""
    logits = paper_net_forward_batched(params, batch["x"], cfg)
    return (logits.argmax(dim=-1) == batch["y"]).to(torch.float32)


def paper_net_accuracy_batched(params: Dict, batch: Dict,
                               cfg: PaperNetConfig) -> torch.Tensor:
    """-> [P] per-client masked-mean accuracy."""
    return _masked_mean(paper_net_correct(params, batch, cfg),
                        batch.get("mask"))


# ---------------------------------------------------------------------------
# one model: the P = 1 case
# ---------------------------------------------------------------------------

def _one(params: Dict, batch: Dict) -> tuple:
    return ({k: v[None] for k, v in params.items()},
            {k: v[None] for k, v in batch.items() if v is not None})


def paper_net_forward(params: Dict, x: torch.Tensor,
                      cfg: PaperNetConfig) -> torch.Tensor:
    """x: logreg [B, D] float; cnn [B, H, W, C] float; lstm [B, T] int."""
    p, b = _one(params, {"x": x})
    return paper_net_forward_batched(p, b["x"], cfg)[0]


def paper_net_loss(params: Dict, batch: Dict,
                   cfg: PaperNetConfig) -> torch.Tensor:
    """batch: {"x": inputs, "y": [B] int labels, "mask": [B] 0/1}."""
    p, b = _one(params, batch)
    return paper_net_loss_batched(p, b, cfg)[0]


def paper_net_accuracy(params: Dict, batch: Dict,
                       cfg: PaperNetConfig) -> torch.Tensor:
    p, b = _one(params, batch)
    return paper_net_accuracy_batched(p, b, cfg)[0]
