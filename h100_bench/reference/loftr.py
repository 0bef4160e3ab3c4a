"""Plain LoFTR, outdoor dual-softmax (Sun et al., 2021; zju3dv/LoFTR
`src/loftr/`: `backbone/resnet_fpn.py`, `utils/position_encoding.py`,
`loftr_module/transformer.py` and `linear_attention.py`,
`utils/coarse_matching.py`, `loftr_module/fine_preprocess.py`,
`utils/fine_matching.py`), for one tile pair at a time:

  ResNet-FPN 8-2 (initial dim 128, blocks 128-196-256, inference batch
  norm, 2x bilinear upsampling with aligned corners) -> coarse 1/8 x 256
  and fine 1/2 x 128 maps
  sinusoidal position encoding, temp_bug_fix false (the published
  checkpoints' operator-precedence slip: the div term is
  exp(-arange(0, d/2, 2)))
  coarse transformer: 4 x (self, cross) linear-attention layers, d 256,
  8 heads, elu + 1 feature map, each a 2d -> 2d -> d MLP on [x | message]
  and two layer norms; the cross updates sequential
  dual softmax over the L0 x L1 similarity (T 0.1); a match is a mutual
  maximum of the confidence matrix above the threshold, off the 2-cell
  border
  fine stage: 5 x 5 windows of the fine map (unfold, stride 4) merged
  with the down-projected coarse feature, 1 x (self, cross) at d 128,
  the centre's softmax over the window and its expected position

Departures from the published model, each also the program's:
`temp_bug_fix` false as the checkpoints were trained; the matches of a
tile pair are its `max_matches` most confident (the published model keeps
every one above the threshold); no padding masks (the tiles lie whole
inside their frames, so the published model passes none either).

Everything is float32 with TF32 off (`precision.full_f32` around the
calls). `precisions` names the operand precision of the backbone's
convolutions ("backbone"), the transformers' and the fine stage's
products ("transformer") and the similarity ("similarity"); the control
rounds them lower. Weights come as the tree `models.convert.loftr_params`
reads (convolutions {"w" HWIO}, dense {"w" (in, out), "b"}, batch and
layer norms {"scale", "bias"[, "mean", "var"]}, the transformer stacks
with a leading pair axis); `random_tree` draws one on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from h100_bench.reference.precision import round_to

BN_EPS = 1e-5
LN_EPS = 1e-5
ATTN_EPS = 1e-6


# -- backbone -------------------------------------------------------------

def _conv(x, p, prec, stride=1):
    w = p["w"].permute(3, 2, 0, 1)
    return F.conv2d(round_to(x, prec), round_to(w, prec), stride=stride,
                    padding=w.shape[-1] // 2)


def _bn(x, p):
    return F.batch_norm(x, p["mean"], p["var"], p["scale"], p["bias"],
                        training=False, eps=BN_EPS)


def _block(x, p, prec, stride):
    y = F.relu(_bn(_conv(x, p["conv1"], prec, stride), p["bn1"]))
    y = _bn(_conv(y, p["conv2"], prec), p["bn2"])
    if "down_conv" in p:
        x = _bn(_conv(x, p["down_conv"], prec, stride), p["down_bn"])
    return F.relu(x + y)


def _outconv2(x, p, prec):
    y = F.leaky_relu(_bn(_conv(x, p["conv1"], prec), p["bn"]), 0.01)
    return _conv(y, p["conv2"], prec)


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="bilinear",
                         align_corners=True)


def backbone(p: dict, img: torch.Tensor, prec: str) -> tuple:
    """(B, 1, H, W) -> coarse (B, 256, H/8, W/8), fine (B, 128, H/2, W/2)."""
    x1 = F.relu(_bn(_conv(img, p["conv1"], prec, 2), p["bn1"]))
    for blk in p["layer1"]:
        x1 = _block(x1, blk, prec, 1)
    x2 = _block(_block(x1, p["layer2"][0], prec, 2), p["layer2"][1], prec, 1)
    x3 = _block(_block(x2, p["layer3"][0], prec, 2), p["layer3"][1], prec, 1)
    x3_out = _conv(x3, p["layer3_outconv"], prec)
    x2_out = _outconv2(_conv(x2, p["layer2_outconv"], prec) + _up2(x3_out),
                       p["layer2_outconv2"], prec)
    x1_out = _outconv2(_conv(x1, p["layer1_outconv"], prec) + _up2(x2_out),
                       p["layer1_outconv2"], prec)
    return x3_out, x1_out


def position_encoding(d: int, h: int, w: int, device) -> torch.Tensor:
    """(d, h, w), the published `PositionEncodingSine` with
    temp_bug_fix false, in float32 as published."""
    y = torch.ones((h, w), device=device).cumsum(0)[None]
    x = torch.ones((h, w), device=device).cumsum(1)[None]
    div = torch.exp(torch.arange(0, d // 2, 2, device=device).float()
                    * (-math.log(10000.0) / d // 2))[:, None, None]
    pe = torch.zeros((d, h, w), device=device)
    pe[0::4] = torch.sin(x * div)
    pe[1::4] = torch.cos(x * div)
    pe[2::4] = torch.sin(y * div)
    pe[3::4] = torch.cos(y * div)
    return pe


# -- transformer ----------------------------------------------------------

def _dense(x, p, prec):
    y = round_to(x, prec) @ round_to(p["w"], prec)
    return y + p["b"] if "b" in p else y


def _ln(x, p):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], LN_EPS)


def _linear_attention(q, k, v, prec):
    fq, fk = F.elu(q) + 1, F.elu(k) + 1
    n = v.shape[1]
    v = v / n
    kv = torch.einsum("nshd,nshv->nhdv", round_to(fk, prec), round_to(v, prec))
    z = 1 / (torch.einsum("nlhd,nhd->nlh", round_to(fq, prec),
                          round_to(fk.sum(1), prec)) + ATTN_EPS)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", round_to(fq, prec),
                        round_to(kv, prec), z) * n


def _layer(p, x, source, heads, prec):
    b, _, d = x.shape
    q = _dense(x, p["q_proj"], prec).view(b, -1, heads, d // heads)
    k = _dense(source, p["k_proj"], prec).view(b, -1, heads, d // heads)
    v = _dense(source, p["v_proj"], prec).view(b, -1, heads, d // heads)
    msg = _linear_attention(q, k, v, prec).reshape(b, -1, d)
    msg = _ln(_dense(msg, p["merge"], prec), p["norm1"])
    msg = _dense(F.relu(_dense(torch.cat([x, msg], -1), p["mlp0"], prec)),
                 p["mlp2"], prec)
    return x + _ln(msg, p["norm2"])


def _pair(stack: dict, i: int) -> dict:
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(stack)


def transformer(stack: dict, f0, f1, heads: int, prec: str) -> tuple:
    """(self, cross) pairs of the stack in order; the cross updates are
    sequential (feat1 attends to the updated feat0)."""
    for i in range(stack["self"]["q_proj"]["w"].shape[0]):
        p = _pair(stack, i)
        f0 = _layer(p["self"], f0, f0, heads, prec)
        f1 = _layer(p["self"], f1, f1, heads, prec)
        f0 = _layer(p["cross"], f0, f1, heads, prec)
        f1 = _layer(p["cross"], f1, f0, heads, prec)
    return f0, f1


# -- the forward ------------------------------------------------------------

def _border(h: int, w: int, rm: int, device) -> torch.Tensor:
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    m[rm:h - rm, rm:w - rm] = True
    return m.reshape(-1)


@torch.inference_mode()
def forward(tree: dict, img0: torch.Tensor, img1: torch.Tensor, cfg: dict,
            precisions: dict, thr: float, max_matches: int,
            keep_conf: bool = False) -> dict:
    """One tile pair, (H, W) float images in [0, 1] with sides multiples
    of 8 -> {"i", "j" (M,) coarse cells, "conf" (M,), "kpts0", "kpts1"
    (M, 2) px}: the `max_matches` most confident matches, most confident
    first; with `keep_conf` also the (L0, L1) "conf_matrix"."""
    pb, pt = precisions["backbone"], precisions["transformer"]
    d, heads = cfg["d_model_c"], cfg["nhead"]
    fc, ff = backbone(tree["backbone"], torch.stack([img0, img1])[:, None],
                      pb)
    out = {}
    hc, wc = fc.shape[2:]
    pe = position_encoding(d, hc, wc, fc.device)
    tok = (fc + pe).flatten(2).transpose(1, 2)              # (2, L, d)
    c0, c1 = transformer(tree["coarse"], tok[:1], tok[1:], heads, pt)

    # dual-softmax coarse matching
    n0, n1 = c0[0] / d ** 0.5, c1[0] / d ** 0.5
    ps = precisions["similarity"]
    sim = round_to(n0, ps) @ round_to(n1, ps).T / cfg["dsmax_temperature"]
    conf = F.softmax(sim, 0) * F.softmax(sim, 1)
    del sim
    if keep_conf:
        out["conf_matrix"] = conf
    ok = (conf > thr) & (conf == conf.amax(1, keepdim=True))
    ok &= conf == conf.amax(0, keepdim=True)
    border = _border(hc, wc, cfg["border_rm"], conf.device)
    ok &= border[:, None] & border[None, :]
    hit, j = ok.max(1)
    del ok
    i = torch.nonzero(hit)[:, 0]
    j = j[i]
    mconf = conf[i, j]
    del conf
    order = torch.argsort(mconf, descending=True, stable=True)[:max_matches]
    i, j, mconf = i[order], j[order], mconf[order]

    # fine preprocessing: 5 x 5 windows at stride 4, merged with the
    # down-projected coarse feature
    w = cfg["fine_window"]
    ww = w * w
    stride = ff.shape[2] // hc
    fp = tree["fine_preprocess"]
    unf = F.unfold(ff, kernel_size=(w, w), stride=stride, padding=w // 2)
    unf = unf.reshape(2, ff.shape[1], ww, -1).permute(0, 3, 2, 1)
    win = torch.cat([unf[0, i], unf[1, j]])                  # (2M, ww, cf)
    cwin = _dense(torch.cat([c0[0, i], c1[0, j]]), fp["down_proj"], pt)
    merged = _dense(torch.cat([win, cwin[:, None].expand(-1, ww, -1)], -1),
                    fp["merge_feat"], pt)
    f0, f1 = merged.chunk(2)
    f0, f1 = transformer(tree["fine"], f0, f1, cfg["nhead"], pt)

    # fine matching: expectation of the centre's softmax over the window
    c = f0.shape[-1]
    s = torch.einsum("mc,mrc->mr", round_to(f0[:, ww // 2], pt),
                     round_to(f1, pt))
    heat = F.softmax(s / c ** 0.5, 1)
    g = torch.linspace(-1.0, 1.0, w, device=heat.device)
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    coords = heat @ grid
    scale = img0.shape[0] // hc
    cell0 = torch.stack([i % wc, i // wc], -1).float() * scale
    cell1 = torch.stack([j % wc, j // wc], -1).float() * scale
    fine_scale = scale // stride
    out.update(i=i, j=j, conf=mconf, kpts0=cell0,
               kpts1=cell1 + coords * (w // 2) * fine_scale)
    return out


# -- weights ----------------------------------------------------------------

def random_tree(generator: torch.Generator, device, cfg: dict) -> dict:
    """LoFTR weights at the widths of `cfg` (initial_dim, block_dims,
    d_model_c, d_model_f, coarse_pairs, fine_pairs) drawn from
    `generator` on `device`: kernels normal with std 1 / sqrt(fan in),
    dense biases normal(0, 0.1). Unlike the program's `loftr_tree`,
    batch norms and layer norms are not the identity: means and biases
    are normal(0, 0.1), variances uniform in [0.05, 0.5] and the batch
    norms' scales sqrt(var) times a uniform [0.7, 1.3] (so each keeps
    its input's scale), the layer norms' scales uniform [0.7, 1.3]. A
    slip in the program's batch-norm arithmetic or eps then shows."""
    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=generator, device=device) * std

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)

    def conv(k, cin, cout):
        return {"w": normal(k, k, cin, cout, std=(k * k * cin) ** -0.5)}

    def bn(c):
        var = uniform(0.05, 0.5, c)
        return {"scale": var.sqrt() * uniform(0.7, 1.3, c),
                "bias": normal(c, std=0.1), "mean": normal(c, std=0.1),
                "var": var}

    def block(cin, cout, stride):
        p = {"conv1": conv(3, cin, cout), "bn1": bn(cout),
             "conv2": conv(3, cout, cout), "bn2": bn(cout)}
        if stride != 1:
            p["down_conv"] = conv(1, cin, cout)
            p["down_bn"] = bn(cout)
        return p

    def dense(din, dout, bias=False):
        p = {"w": normal(din, dout, std=din ** -0.5)}
        if bias:
            p["b"] = normal(dout, std=0.1)
        return p

    def ln(d):
        return {"scale": uniform(0.7, 1.3, d), "bias": normal(d, std=0.1)}

    def layer(d):
        return {"q_proj": dense(d, d), "k_proj": dense(d, d),
                "v_proj": dense(d, d), "merge": dense(d, d),
                "mlp0": dense(2 * d, 2 * d), "mlp2": dense(2 * d, d),
                "norm1": ln(d), "norm2": ln(d)}

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    def pairs(d, n):
        return stack([{"self": layer(d), "cross": layer(d)}
                      for _ in range(n)])

    i0 = cfg["initial_dim"]
    d0, d1, d2 = cfg["block_dims"]
    dc, df = cfg["d_model_c"], cfg["d_model_f"]
    return {
        "backbone": {
            "conv1": conv(7, 1, i0), "bn1": bn(i0),
            "layer1": [block(i0, d0, 1), block(d0, d0, 1)],
            "layer2": [block(d0, d1, 2), block(d1, d1, 1)],
            "layer3": [block(d1, d2, 2), block(d2, d2, 1)],
            "layer3_outconv": conv(1, d2, d2),
            "layer2_outconv": conv(1, d1, d2),
            "layer2_outconv2": {"conv1": conv(3, d2, d2), "bn": bn(d2),
                                "conv2": conv(3, d2, d1)},
            "layer1_outconv": conv(1, d0, d1),
            "layer1_outconv2": {"conv1": conv(3, d1, d1), "bn": bn(d1),
                                "conv2": conv(3, d1, d0)}},
        "coarse": pairs(dc, cfg["coarse_pairs"]),
        "fine_preprocess": {"down_proj": dense(dc, df, bias=True),
                            "merge_feat": dense(2 * df, df, bias=True)},
        "fine": pairs(df, cfg["fine_pairs"])}
