"""Plain reference of a dense decoder-only transformer (Granite-3, Qwen3):
its forward, its Phase-2 loss (Eqs. 3 and 4 of the paper) with gradients,
and AdamW, in float32 arithmetic with no kernel, cache or batching trick.

It follows the configuration file as run: RMSNorm, GQA attention with
split-half RoPE (optionally per-head q/k RMSNorm), a SiLU-gated MLP, an
untied output head over the true vocabulary, and the Granite multipliers
where the file states them.  Parameters arrive in the bf16 tree the
benchmark drew; each layer is widened to float32 where it is used.  The
control (``prec="fp8"``) runs the same arithmetic with every matrix
product's operands rounded to float8 e4m3 under one scale a tensor: the
step below the configuration's bfloat16.

Imports nothing but torch and the standard library.

It is the first architecture module: a configuration file names it in its
``reference`` key and the benchmark reaches everything that depends on the
architecture through it (``benchlib.spec.architecture``).  An architecture
module provides:

- ``dims(conf)``: the dict a run carries as ``Run.dims``, which the FLOP
  counts and the metric readers read; it holds ``layers`` (blocks),
  ``attn_layers`` (blocks that run attention), the attention widths ``h``,
  ``n``, ``hd`` and ``d``, ``vocab`` and ``vocab_padded``.
- ``leaf_specs(conf)``: [(path, shape, init)] of every parameter leaf in
  the program's tree, in the order the leaves are drawn (each leaf's
  generator is seeded by its index); ``init`` is a standard deviation or
  "ones".
- ``forward_flops(k, batch, seq)``, ``prefill_flops(k, prompt)`` and
  ``decode_token_flops(k, context)``: useful FLOPs of a forward pass, of a
  prompt's prefill and of one served token, from ``k = dims(conf)``.
- ``served_logit_gaps(conf, params, sequences, served, precs)``: the
  serving comparison (below).
- ``follow_steps(conf, traffic, names, student_leaf, teacher, buffer,
  batch_of, steps, prec)``: the Phase-2 comparison (below); a module for
  serving only leaves it out, and a Phase-2 cell refuses it at set-up.

Several kinds of layer, expert leaves and attention in only some layers
are the module's own business: its ``leaf_specs`` lists every leaf, its
``dims`` counts ``attn_layers``, and its FLOP counts take the active
experts only.  The loader hands the module the yardstick's formulas
(``benchlib/flops.py``) as ``flops``; this one's counts are those
formulas.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

E4M3_MAX = 448.0
# the yardstick's formulas (``benchlib/flops.py``), set by the loader
flops = None


def dims(conf: dict) -> dict:
    """The widths the tree, the operation counts and the reference use,
    from the configuration file's published keys; every layer runs
    attention."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    vocab = conf["vocab_size"]
    pad = conf["program"].get("vocab_pad", 256)
    layers = conf["num_hidden_layers"]
    return {"d": d, "h": h, "n": conf["num_key_value_heads"],
            "hd": conf.get("head_dim") or d // h,
            "ff": conf["intermediate_size"],
            "layers": layers, "attn_layers": layers,
            "vocab": vocab, "vocab_padded": -(-vocab // pad) * pad,
            "qk_norm": bool(conf["program"].get("qk_norm", False))}


def leaf_specs(conf: dict):
    """[(path, shape, init)] of every parameter leaf: the program's tree,
    layers stacked on a leading axis under ``blocks.b0``."""
    k = dims(conf)
    d, h, n, hd, ff, L = k["d"], k["h"], k["n"], k["hd"], k["ff"], k["layers"]
    vp = k["vocab_padded"]
    sd = 1.0 / math.sqrt(d)
    blk = ("blocks", "b0")
    specs = [(("embed", "table"), (vp, d), 0.02),
             (blk + ("ln1", "scale"), (L, d), "ones"),
             (blk + ("mixer", "wq"), (L, d, h, hd), sd),
             (blk + ("mixer", "wk"), (L, d, n, hd), sd),
             (blk + ("mixer", "wv"), (L, d, n, hd), sd),
             (blk + ("mixer", "wo"), (L, h, hd, d), sd)]
    if k["qk_norm"]:
        specs += [(blk + ("mixer", "q_norm"), (L, hd), "ones"),
                  (blk + ("mixer", "k_norm"), (L, hd), "ones")]
    specs += [(blk + ("ln2", "scale"), (L, d), "ones"),
              (blk + ("mlp", "up", "w"), (L, d, ff), sd),
              (blk + ("mlp", "gate", "w"), (L, d, ff), sd),
              (blk + ("mlp", "down", "w"), (L, ff, d), 1.0 / math.sqrt(ff)),
              (("ln_f", "scale"), (d,), "ones"),
              (("unembed", "w"), (d, vp), sd)]
    return specs


def forward_flops(k: dict, batch: int, seq: int) -> float:
    return flops.forward_flops(k, batch, seq)


def prefill_flops(k: dict, prompt: int) -> float:
    return flops.prefill_flops(k, prompt)


def decode_token_flops(k: dict, context: int) -> float:
    return flops.decode_token_flops(k, context)


def _fp8(x):
    """``x`` rounded to float8 e4m3 under one scale (its max over 448); the
    gradient passes straight through."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _mm(a, b, prec):
    if prec == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, theta):
    """x (S, H, D) f32, pos (S,): the first D/2 features rotate against
    the last D/2 by angles pos * theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = pos.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, scale, prec, q_block=512):
    """Causal GQA over one sequence: q (S, H, D), k/v (S, N, D); queries
    in blocks so the f32 scores of one block are alive at a time."""
    s, h, d = q.shape
    n = k.shape[1]
    g = h // n
    kk = k.permute(1, 2, 0)                      # (N, D, S)
    vv = v.permute(1, 0, 2)                      # (N, S, D)
    outs = []
    for lo in range(0, s, q_block):
        hi = min(lo + q_block, s)
        qb = q[lo:hi].reshape(hi - lo, n, g, d).permute(1, 0, 2, 3)
        qb = qb.reshape(n, (hi - lo) * g, d)     # (N, Q*G, D)
        sc = _mm(qb, kk, prec).reshape(n, hi - lo, g, s) * scale
        qpos = torch.arange(lo, hi, device=q.device)[:, None, None]
        kpos = torch.arange(s, device=q.device)[None, None, :]
        sc = sc.masked_fill((kpos > qpos)[None], float("-inf"))
        p = torch.softmax(sc, dim=-1).reshape(n, (hi - lo) * g, s)
        o = _mm(p, vv, prec).reshape(n, hi - lo, g, d)
        outs.append(o.permute(1, 0, 2, 3).reshape(hi - lo, h, d))
    return torch.cat(outs, dim=0)


class Model:
    """The configuration's hyper-parameters and the layer function."""

    def __init__(self, conf: dict):
        self.d = conf["hidden_size"]
        self.h = conf["num_attention_heads"]
        self.n = conf["num_key_value_heads"]
        self.hd = conf.get("head_dim") or self.d // self.h
        self.layers = conf["num_hidden_layers"]
        self.vocab = conf["vocab_size"]
        self.eps = conf["rms_norm_eps"]
        self.theta = float(conf["rope_theta"])
        self.qk_norm = conf["program"].get("qk_norm", False)
        self.scale = conf.get("attention_multiplier",
                              1.0 / math.sqrt(self.hd))
        self.emb_mult = conf.get("embedding_multiplier", 1.0)
        self.res_mult = conf.get("residual_multiplier", 1.0)
        self.logit_scale = conf.get("logits_scaling", 1.0)

    def layer(self, x, pos, w, prec):
        """One layer over one sequence x (S, d) f32; ``w`` the layer's f32
        weights in the program's layouts."""
        s = x.shape[0]
        hx = _rms(x, w["ln1"], self.eps)
        q = _mm(hx, w["wq"].reshape(self.d, -1), prec).reshape(s, self.h,
                                                                 self.hd)
        k = _mm(hx, w["wk"].reshape(self.d, -1), prec).reshape(s, self.n,
                                                                 self.hd)
        v = _mm(hx, w["wv"].reshape(self.d, -1), prec).reshape(s, self.n,
                                                                 self.hd)
        if self.qk_norm:
            q = _rms(q, w["q_norm"], self.eps)
            k = _rms(k, w["k_norm"], self.eps)
        q, k = _rope(q, pos, self.theta), _rope(k, pos, self.theta)
        o = _attention(q, k, v, self.scale, prec).reshape(s, -1)
        x = x + self.res_mult * _mm(o, w["wo"].reshape(-1, self.d), prec)
        hx = _rms(x, w["ln2"], self.eps)
        m = torch.nn.functional.silu(_mm(hx, w["gate"], prec)) \
            * _mm(hx, w["up"], prec)
        return x + self.res_mult * _mm(m, w["down"], prec)

    def logits(self, x, ln_f, unembed, prec):
        """(rows, vocab) f32 over the true vocabulary."""
        hx = _rms(x, ln_f, self.eps)
        return _mm(hx, unembed[:, :self.vocab], prec) / self.logit_scale


_LAYER_KEYS = {"ln1": ("ln1", "scale"), "wq": ("mixer", "wq"),
               "wk": ("mixer", "wk"), "wv": ("mixer", "wv"),
               "wo": ("mixer", "wo"), "q_norm": ("mixer", "q_norm"),
               "k_norm": ("mixer", "k_norm"), "ln2": ("ln2", "scale"),
               "up": ("mlp", "up", "w"), "gate": ("mlp", "gate", "w"),
               "down": ("mlp", "down", "w")}


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def layer_weights(params, i, model):
    """Layer ``i``'s weights of a stacked tree, widened to f32."""
    blk = params["blocks"]["b0"]
    keys = [k for k in _LAYER_KEYS
            if model.qk_norm or k not in ("q_norm", "k_norm")]
    return {k: _get(blk, _LAYER_KEYS[k])[i].float() for k in keys}


def hidden_frozen(model, params, tokens, prec):
    """Final hidden states (B, S, d) f32 of a frozen model (no gradient)."""
    with torch.no_grad():
        xs = [params["embed"]["table"][t].float() * model.emb_mult
              for t in tokens]
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        for i in range(model.layers):
            w = layer_weights(params, i, model)
            xs = [model.layer(x, pos, w, prec) for x in xs]
        return torch.stack(xs)


# ---------------------------------------------------------------------------
# Training: the Phase-2 step (student forward and backward, frozen teacher
# and buffer) and AdamW, followed for a few steps.
# ---------------------------------------------------------------------------

def _student_hidden(model, leaves, tokens, prec):
    """Hidden states of the student (f32 leaves with gradients), each
    layer under checkpoint so only the layers' inputs are kept."""
    table = leaves["embed.table"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    per = {k: leaves["blocks.b0." + ".".join(_LAYER_KEYS[k])].unbind(0)
           for k in _LAYER_KEYS
           if model.qk_norm or k not in ("q_norm", "k_norm")}
    keys = list(per)
    xs = []
    for t in tokens:
        x = table[t] * model.emb_mult
        for i in range(model.layers):
            def run(x, *ws):
                return model.layer(x, pos, dict(zip(keys, ws)), prec)
            x = torch.utils.checkpoint.checkpoint(
                run, x, *[per[k][i] for k in keys], use_reentrant=False)
        xs.append(x)
    return torch.stack(xs)


def _kd_rows(model, hs, ht, hb, labels, ln_f, unembed, frozen, tau, prec):
    """Summed per-row loss CE + tau^2 KL(t||s) [+ tau^2 KL(b||s)] over a
    block of rows; teacher and buffer logits come from ``frozen``."""
    s = model.logits(hs, ln_f, unembed, prec)
    lse = torch.logsumexp(s, -1)
    ce = lse - s.gather(-1, labels[:, None])[:, 0]
    ls = torch.log_softmax(s / tau, -1)
    loss = ce
    for h, head in zip((ht, hb), frozen):
        if h is None:
            continue
        with torch.no_grad():
            lt = torch.log_softmax(model.logits(h, *head, prec) / tau, -1)
        loss = loss + tau ** 2 * (lt.exp() * (lt - ls)).sum(-1)
    return loss.sum()


def phase2_loss(model, leaves, teacher, buffer, batch, tau, prec,
                row_block=2048):
    """Mean Phase-2 loss over every token of the batch (the student's
    graph kept); the rows' logits in blocks, each under checkpoint."""
    tokens, labels = batch["tokens"], batch["labels"]
    hs = _student_hidden(model, leaves, tokens, prec).reshape(-1, model.d)
    ht = hidden_frozen(model, teacher, tokens, prec).reshape(-1, model.d)
    hb = (hidden_frozen(model, buffer, tokens, prec).reshape(-1, model.d)
          if buffer is not None else None)
    frozen = [(teacher["ln_f"]["scale"].float(),
               teacher["unembed"]["w"].float())]
    frozen.append((buffer["ln_f"]["scale"].float(),
                   buffer["unembed"]["w"].float()) if buffer is not None
                  else None)
    y = labels.reshape(-1)
    rows = y.shape[0]
    total = 0.0
    for lo in range(0, rows, row_block):
        sl = slice(lo, lo + row_block)
        hbb = hb[sl] if hb is not None else None
        total = total + torch.utils.checkpoint.checkpoint(
            _kd_rows, model, hs[sl], ht[sl], hbb, y[sl],
            leaves["ln_f.scale"], leaves["unembed.w"], frozen, tau, prec,
            use_reentrant=False)
    return total / rows


def adamw_(p, g, m, v, t, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """One AdamW update of f32 ``p``, ``m``, ``v`` in place (step ``t``
    from 1), decoupled weight decay as the configuration states."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    d = (m / c1) / (torch.sqrt(v / c2) + eps)
    p.sub_(lr * (d + wd * p))


def follow_steps(conf, traffic, names, student_leaf, teacher, buffer, batch_of,
                 steps, prec="f32"):
    """Train the student ``steps`` Phase-2 steps from the drawn start.

    ``names`` are the leaves' dotted paths; ``student_leaf(i)`` the bf16
    start of leaf i; ``teacher``/``buffer`` bf16 trees (buffer None for
    plain KD); ``batch_of(step)`` the feed.  Parameters keep the
    configuration's type: each update is taken in f32 and rounded to it.
    Returns the loss of every step, the first gradient's norm of every
    leaf, and every leaf's f32 parameters after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(conf)
    dtype = student_leaf(0).dtype
    leaves = {n: student_leaf(i).float() for i, n in enumerate(names)}
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    losses, grad_norms = [], None
    for step in range(steps):
        params = {n: p.requires_grad_() for n, p in leaves.items()}
        loss = phase2_loss(model, params, teacher, buffer, batch_of(step),
                           traffic["tau"], prec)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = [float(g.norm()) for g in grads]
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                p = p.detach()
                adamw_(p, g, m[n], v[n], step + 1, traffic["lr"])
                leaves[n] = p.to(dtype).float()
        del grads, params, loss
    return losses, grad_norms, leaves


# ---------------------------------------------------------------------------
# Serving: logits of the served positions.
# ---------------------------------------------------------------------------

def served_logit_gaps(conf, params, sequences, served, precs=("f32",)):
    """For every sequence (prompt + served tokens but the last, (T,) ids)
    and its served tokens ``served`` (n,), the f32 logits at the n
    positions that produced them.  Returns, per sequence, (gap of each
    served token below the f32 best, and for each other precision in
    ``precs`` the gap of the token that precision puts first)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = Model(conf)
    table = params["embed"]["table"]
    with torch.no_grad():
        hs = {p: [table[s].float() * model.emb_mult for s in sequences]
              for p in precs}
        for i in range(model.layers):
            w = layer_weights(params, i, model)
            for p in precs:
                hs[p] = [model.layer(x, torch.arange(x.shape[0],
                                                     device=x.device), w, p)
                         for x in hs[p]]
        ln_f = params["ln_f"]["scale"].float()
        un = params["unembed"]["w"].float()
        out = []
        for j, (seq, toks) in enumerate(zip(sequences, served)):
            n = toks.shape[0]
            rows = slice(seq.shape[0] - n, seq.shape[0])
            ref = model.logits(hs["f32"][j][rows], ln_f, un, "f32")
            best = ref.max(-1).values
            ok = toks < model.vocab         # a padding id is never served
            got = ref.gather(-1, toks.clamp(max=model.vocab - 1)[:, None])
            gaps = torch.where(ok, best - got[:, 0], float("inf"))
            others = {}
            for p in precs[1:]:
                pick = model.logits(hs[p][j][rows], ln_f, un, p).argmax(-1)
                others[p] = best - ref.gather(-1, pick[:, None])[:, 0]
            out.append((gaps, others))
    return out
