"""Plain PyTorch pieces of the references: dense layers, norms, typed
message passing written out edge by edge, the losses and Adam.

Nothing here imports the program.  Parameters are a dict of tensors keyed
by the names of the configuration's parameter tree (``specs``); every
function takes them in the dtype it should compute in.  A ``Counter``
passed to a forward counts its operations as the benchmark's yardstick
does: 2 per multiply-add of every dense layer and of each conv's
``x @ W`` (per source row, both halves of an extension conv's filters),
plus 2 K T C per destination row of each conv.  Each conv is also
listed, with its shapes and aggregator, for the roofline reader.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Counter:
    flops: int = 0
    convs: list = dataclasses.field(default_factory=list)


# ------------------------------------------------------------------ specs
# (name, shape, kind): kind "w" draws U(+-1/sqrt(fan_in)) with fan_in the
# input width, "bn_w" U(0.5, 1.5), "b" U(-0.1, 0.1); "zero" and "one" are
# the running statistics' starting values.

def dense_spec(name, nin, nout, bias=True):
    out = [(f"{name}.weight", (nout, nin), "w")]
    return out + ([(f"{name}.bias", (nout,), "b")] if bias else [])


def bn_spec(name, c):
    return [(f"{name}.weight", (c,), "bn_w"), (f"{name}.bias", (c,), "b"),
            (f"{name}.running_mean", (c,), "zero"),
            (f"{name}.running_var", (c,), "one")]


def mpconv_spec(name, nin, nout, T, ext):
    cin = 2 * nin if ext else nin
    return ([(f"{name}.filters", (cin, nout * T), "w_rows"),
             (f"{name}.bias", (nout,), "b")] + bn_spec(f"{name}.bn", nout))


def mpres_spec(name, nin, nmed, nout, T, ext):
    return (dense_spec(f"{name}.conv1", nin, nmed) + bn_spec(f"{name}.bn1", nmed)
            + mpconv_spec(f"{name}.mp_conv", nmed, nmed, T, ext)
            + dense_spec(f"{name}.conv2", nmed, nout)
            + bn_spec(f"{name}.bn2", nout))


def mlp_spec(name, nin, widths):
    out = []
    for i, w in enumerate(widths):
        out += dense_spec(f"{name}.dense_{i}", nin, w)
        nin = w
    return out


def init_bounds(spec):
    """(low, high) of each entry's uniform draw."""
    name, shape, kind = spec
    if kind == "w":
        b = 1.0 / math.sqrt(shape[1])
        return -b, b
    if kind == "w_rows":
        b = 1.0 / math.sqrt(shape[0])
        return -b, b
    return {"bn_w": (0.5, 1.5), "b": (-0.1, 0.1), "zero": (0.0, 0.0),
            "one": (1.0, 1.0)}[kind]


def is_parameter(spec) -> bool:
    return spec[2] not in ("zero", "one")


def placeholders(specs, device) -> dict:
    """Parameters of the right shapes for counting operations: ones where
    the value scales (BatchNorm scales, running variances), else zeros."""
    return {name: torch.full(shape, 1.0 if kind in ("one", "bn_w") else 0.0,
                             device=device)
            for name, shape, kind in specs}


# ----------------------------------------------------------------- layers

def dense(x, P, name, ctr=None):
    w = P[f"{name}.weight"]
    if ctr is not None:
        ctr.flops += 2 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1]
    y = x @ w.t()
    b = P.get(f"{name}.bias")
    return y if b is None else y + b


def batch_norm(x, P, name, train, eps=1e-5):
    """Normalise each channel over every other axis: the batch's biased
    statistics in training, the running ones in evaluation."""
    if train:
        dims = tuple(range(x.ndim - 1))
        mean = x.mean(dim=dims)
        var = (x - mean).square().mean(dim=dims)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return ((x - mean) * torch.rsqrt(var + eps) * P[f"{name}.weight"]
            + P[f"{name}.bias"])


def instance_norm(x, eps=1e-5):
    """Per (sample, channel) over the node axis of (B, N, C)."""
    mean = x.mean(dim=-2, keepdim=True)
    var = (x - mean).square().mean(dim=-2, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def segment_instance_norm(x, seg, n_seg, eps=1e-5):
    """Per (segment, channel) over the rows of x (N, C) with segment ids
    ``seg`` (N,)."""
    cnt = torch.zeros(n_seg, dtype=x.dtype, device=x.device).index_add_(
        0, seg, torch.ones_like(x[:, 0]))[:, None]
    mean = torch.zeros(n_seg, x.shape[1], dtype=x.dtype,
                       device=x.device).index_add_(0, seg, x) / cnt
    dev = x - mean[seg]
    var = torch.zeros(n_seg, x.shape[1], dtype=x.dtype,
                      device=x.device).index_add_(0, seg, dev.square()) / cnt
    return dev * torch.rsqrt(var[seg] + eps)


def leaky(x):
    return F.leaky_relu(x, 0.01)


def mlp(x, P, name, n, ctr=None):
    for i in range(n):
        x = dense(x, P, f"{name}.dense_{i}", ctr)
        if i < n - 1:
            x = torch.relu(x)
    return x


def aggregate(m, aggregator, gamma, dim):
    if aggregator == "max":
        return m.amax(dim=dim)
    if aggregator == "softmax":
        return torch.logsumexp(gamma * m, dim=dim) / gamma
    if aggregator == "mean":
        return m.mean(dim=dim)
    if aggregator == "sum":
        return m.sum(dim=dim)
    raise ValueError(f"unknown aggregator {aggregator!r}")


def typed_conv(x, idx, etype, filters, bias, nout, aggregator, gamma=3.0,
               ctr=None):
    """m[b, i, k] = sum_t etype[b, i, k, t] (W_t x[b, idx[i, k]]),
    aggregated over k, plus the bias.  x (B, Ns, Cin), idx (Nd, K) long,
    etype (B, Nd, K, T), filters (Cin, nout T) with column c T + t."""
    B, Ns, cin = x.shape
    Nd, K = idx.shape
    T = etype.shape[-1]
    if ctr is not None:
        ctr.flops += 2 * B * Ns * cin * nout * T + 2 * B * Nd * K * T * nout
        ctr.convs.append(dict(n_src=Ns, nd=Nd, k=K, t=T, c=nout, ext=False,
                              aggregator=aggregator))
    h = (x @ filters).view(B, Ns, nout, T)[:, idx]       # (B, Nd, K, C, T)
    m = torch.einsum("bikct,bikt->bikc", h, etype)
    return aggregate(m, aggregator, gamma, 2) + bias


def diff_conv(x, idx, etype, filters, bias, nout, aggregator, gamma=3.0,
              ctr=None):
    """The DIFF extension over one graph whose sources are its
    destinations: m[i, k] = sum_t etype[i, k, t] (W_t [x_i ; x_i - x_j]),
    j = idx[i, k], aggregated over k, plus the bias.  x (N, Cin),
    idx (N, K) long, etype (N, K, T), filters (2 Cin, nout T)."""
    N, cin = x.shape
    K = idx.shape[1]
    T = etype.shape[-1]
    if ctr is not None:
        ctr.flops += 2 * N * cin * 2 * nout * T + 2 * N * K * T * nout
        ctr.convs.append(dict(n_src=N, nd=N, k=K, t=T, c=nout, ext=True,
                              aggregator=aggregator))
    xi = x[:, None, :].expand(N, K, cin)
    e = torch.cat([xi, xi - x[idx]], dim=-1)               # (N, K, 2 Cin)
    h = (e @ filters).view(N, K, nout, T)
    m = torch.einsum("ikct,ikt->ikc", h, etype)
    return aggregate(m, aggregator, gamma, 1) + bias


# -------------------------------------------------------------- training

def adam_steps(params: dict, grads_fn, n_steps, lr, betas, eps, weight_decay,
               clip=None):
    """n plain Adam steps (the L2 decay added to the gradient, as
    ``torch.optim.Adam``'s ``weight_decay``; gradients first clipped to
    global norm ``clip`` by optax's rule where it is given) on the leaves
    of ``params`` (a dict of tensors, updated in place).  ``grads_fn(step)``
    returns (losses, {name: gradient or None}).  Leaves without a gradient
    are left alone, as torch's Adam leaves them.  Returns (each step's
    losses, the first step's gradients as the optimizer takes them)."""
    b1, b2 = betas
    m, v, t = {}, {}, {}
    losses, first = [], None
    for step in range(n_steps):
        loss, grads = grads_fn(step)
        losses.append(loss)
        live = {k: g for k, g in grads.items() if g is not None}
        if clip is not None and live:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in live.values()]))
            scale = torch.where(norm < clip, torch.ones_like(norm),
                                clip / norm)
            live = {k: g * scale for k, g in live.items()}
        with torch.no_grad():
            if weight_decay:
                live = {k: g + weight_decay * params[k]
                        for k, g in live.items()}
            if first is None:
                first = {k: g.clone() for k, g in live.items()}
            for k, g in live.items():
                t[k] = t.get(k, 0) + 1
                m[k] = b1 * m.get(k, torch.zeros_like(g)) + (1 - b1) * g
                v[k] = b2 * v.get(k, torch.zeros_like(g)) + (1 - b2) * g * g
                mhat = m[k] / (1 - b1 ** t[k])
                vhat = v[k] / (1 - b2 ** t[k])
                params[k] -= lr * mhat / (vhat.sqrt() + eps)
    return losses, first
