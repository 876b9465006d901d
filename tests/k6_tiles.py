"""K6's arithmetic (`vmambair_torch/csrc/oss_tail.cu`) in torch ops, on the
CPU, for the tests to hold against JAX's Pallas kernel and the port's
plain version.

The model follows the kernel step by step: the launch plan (the tile of
the dtype pair and D, `cuda_effn.k6_tile`; the split of the channels over
a cluster, `cuda_effn.k6_split`, at the H100's 132 SMs), the tile walk
(each tile of each image, each rank's slice of channels, pixels past the
image zero), the merged tile rounded to y's dtype and stored in the
kernel's swizzled shared layout (`chunk`), the statistics in the kernel's
order (NTH // pixels channel groups a pixel, each summing its channels in
order; the groups in order; the ranks in order; the mean, then the
centred squares rounded and added), and the output rounded to z's dtype
twice (LN(.), then the gate's product). Each fp32 operation is one torch
fp32 operation, so the sums are the kernel's bits; the fused multiply-add
of the normalisation is taken in fp64 and rounded once, and rsqrt is the
CPU's (the card's rsqrtf is within 2 ulp).
"""

import torch

from vmambair_torch.ops import cuda_effn

NTH = 256   # threads of a block (oss_tail.cu, tail::NTH)
SMS = 132   # the H100's SMs, which k6_split fills


def _bytes(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def consts(ydtype, zdtype, d: int) -> dict:
    """The tile's constants of oss_tail.cu's `Tile` for a launch at D."""
    th, tw = cuda_effn.k6_tile(ydtype, zdtype, d)
    vy, vz = 16 // _bytes(ydtype), 16 // _bytes(zdtype)
    npx = th * tw
    return dict(TH=th, TW=tw, VY=vy, VZ=vz, BX=tw // vy, BY=th // vy,
                NB=(tw // vy) * (th // vy), CK=npx // vy, NPX=npx,
                G=max(1, NTH // npx))


def chunk(k: dict, c, h, kk):
    """oss_tail.cu's `chunk_at`: the shared chunk of channel c's chunk kk
    (tile row h); works on ints and integer tensors."""
    return c * k["CK"] + (kk ^ ((k["BX"] * (h // k["VY"]) + k["NB"] * c)
                                & 7))


def shared_index(k: dict, cb: int) -> torch.Tensor:
    """(cb, TH, TW) -> the element index of each pixel of each channel in
    the block's shared tile (chunk * VY + the element in it)."""
    c = torch.arange(cb)[:, None, None]
    h = torch.arange(k["TH"])[None, :, None]
    w = torch.arange(k["TW"])[None, None, :]
    return chunk(k, c, h, h * k["BX"] + w // k["VY"]) * k["VY"] + \
        w % k["VY"]


def plan(b, d, h, w, ydtype, zdtype) -> tuple[dict, int]:
    k = consts(ydtype, zdtype, d)
    return k, cuda_effn.k6_split(b, d, h, w, (k["TH"], k["TW"]), SMS)


def _fma(a, b, c):
    """fp32 a * b + c rounded once (fp64 holds a * b exactly)."""
    return (a.double() * b.double() + c.double()).float()


def k6_tiles_fwd(y, z, ln_w, ln_b, eps=1e-5):
    """K6 as the kernel computes it: y (B, 2, D, H*W), z (B, D, H, W), each
    fp32 or bf16; returns (B, D, H, W) in z's dtype."""
    b, d, h, w = z.shape
    yd, zd = y.dtype, z.dtype
    k, split = plan(b, d, h, w, yd, zd)
    th, tw, g_n = k["TH"], k["TW"], k["G"]
    y_row = y[:, 0].reshape(b, d, h, w)
    y_col = y[:, 1].reshape(b, d, w, h)
    lw, lb = ln_w.float(), ln_b.float()
    out = torch.empty_like(z)
    for bi in range(b):
        for h0 in range(0, h, th):
            for w0 in range(0, w, tw):
                hs, ws = slice(h0, h0 + th), slice(w0, w0 + tw)
                nh, nw = min(th, h - h0), min(tw, w - w0)
                slices = [(r * d // split, (r + 1) * d // split)
                          for r in range(split)]
                # 1. each rank's merged tile, in its shared layout
                tiles = []
                for c0, c1 in slices:
                    m = torch.zeros(c1 - c0, th, tw)
                    m[:, :nh, :nw] = (
                        y_row[bi, c0:c1, hs, ws].float()
                        + y_col[bi, c0:c1, ws, hs].transpose(1, 2).float())
                    flat = torch.zeros((c1 - c0) * k["CK"] * k["VY"])
                    flat[shared_index(k, c1 - c0).flatten()] = \
                        m.to(yd).float().flatten()
                    # read back through the layout, as the statistics do
                    tiles.append(flat[shared_index(k, c1 - c0)])

                def total(fn):
                    t = None
                    for x in tiles:  # the ranks in order
                        part = None
                        for g in range(g_n):  # the groups in order
                            s = torch.zeros(th, tw)
                            for c in range(g, x.shape[0], g_n):
                                s = s + fn(x[c])
                            part = s if part is None else part + s
                        t = part if t is None else t + part
                    return t

                mu = total(lambda v: v) / d
                var = total(lambda v: (v - mu) * (v - mu)) / d
                rs = torch.rsqrt(var + eps)
                # 3. normalise, gate, round
                for (c0, c1), x in zip(slices, tiles):
                    zn = _fma((x - mu) * rs, lw[c0:c1, None, None],
                              lb[c0:c1, None, None])
                    zt = z[bi, c0:c1, hs, ws].float()
                    o = (zn[:, :nh, :nw].to(zd).float() * zt).to(zd)
                    out[bi, c0:c1, hs, ws] = o
    return out
