"""Dropout masks of one training step, drawn from a CUDA generator in the
order in which the program under test draws them, so that the reference
and the program drop the same elements.

The order is the forward's: each dropout site draws once per step, in the
order the sites run.  An elementwise dropout of x keeps an element where
`torch.rand(x.shape)` >= p.  Attention probabilities of at most 10^6 logits
per (item, head) keep where `torch.rand(B, H, Tq, Tk)` >= p; larger ones
draw one seed, `torch.randint(0, 2^31 - 1, ())`, and keep (item*head bh,
row i, column j) where word j % 4 of Philox4x32-10 at counter
(j / 4, i, bh, 0) and key (seed, 0x6D2B79F5) is >= p * 2^32.

A step computed in micro-batches draws every site's mask for the whole
batch at its first use and hands each micro-batch its slice; a second pass
over the same step reuses the masks.
"""

import torch

FUSED_MIN_LOGITS = 1_000_000
KEY1 = 0x6D2B79F5
MASK32 = 0xFFFFFFFF


def _mulhilo(a, x):
    """(hi, lo) 32-bit words of the 64-bit product of the constant a and
    the int64 tensor x of 32-bit values, without int64 overflow."""
    t1 = a * (x & 0xFFFF)
    t2 = a * (x >> 16)
    low = ((t2 & 0xFFFF) << 16) + t1
    return ((t2 >> 16) + (low >> 32)) & MASK32, low & MASK32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit values; k0, k1 ints."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & MASK32
        k1 = (k1 + 0xBB67AE85) & MASK32
    return c0, c1, c2, c3


def philox_keep(seed, p, bh0, nbh, r0, r1, tk, device):
    """Keep mask [nbh, r1 - r0, tk] of items*heads bh0 .. bh0 + nbh - 1."""
    thr = min(int(p * 2 ** 32), 2 ** 32 - 1)
    n4 = (tk + 3) // 4
    j4 = torch.arange(n4, device=device, dtype=torch.int64)[None, None, :]
    i = torch.arange(r0, r1, device=device, dtype=torch.int64)[None, :, None]
    bh = torch.arange(bh0, bh0 + nbh, device=device, dtype=torch.int64)[:, None, None]
    shape = (nbh, r1 - r0, n4)
    words = philox4x32_10(j4.expand(shape), i.expand(shape), bh.expand(shape),
                          torch.zeros(shape, dtype=torch.int64, device=device),
                          int(seed) & MASK32, KEY1)
    return (torch.stack(words, -1) >= thr).reshape(nbh, r1 - r0, 4 * n4)[..., :tk]


class _Tensor:
    def __init__(self, keep):
        self.keep = keep

    def block(self, r0, r1):
        return self.keep[:, :, r0:r1]


class _Philox:
    """The mask of one attention call, made in blocks of rows and kept."""

    def __init__(self, seed, p, full_items, heads, tq, tk, device):
        self.seed, self.p = seed, p
        self.shape = (full_items, heads, tq, tk)
        self.device = device
        self.mask = None

    def full(self):
        if self.mask is None:
            n, h, tq, tk = self.shape
            self.mask = torch.empty(self.shape, dtype=torch.bool, device=self.device)
            rows = max(1, (1 << 23) // (n * h * tk))
            for r0 in range(0, tq, rows):
                r1 = min(tq, r0 + rows)
                self.mask[:, :, r0:r1] = philox_keep(self.seed, self.p, 0, n * h, r0, r1, tk,
                                                     self.device).view(n, h, r1 - r0, tk)
        return self.mask


class Drops:
    """Hands out one step's masks; `start(b0, b1)` before each pass over
    the images b0 .. b1 - 1 of a batch of `batch` images."""

    def __init__(self, gen, p, batch, device):
        self.gen, self.p, self.batch, self.device = gen, p, batch, device
        self.sites = []
        self.at = 0
        self.b0, self.b1 = 0, batch

    def start(self, b0, b1):
        self.at, self.b0, self.b1 = 0, b0, b1
        return self

    def _site(self, make):
        if self.at == len(self.sites):
            self.sites.append(make())
        site = self.sites[self.at]
        self.at += 1
        return site

    def elementwise(self, shape):
        full = (self.batch,) + tuple(shape[1:])
        keep = self._site(lambda: torch.rand(full, generator=self.gen, device=self.device)
                          >= self.p)
        return keep[self.b0:self.b1]

    def attention(self, shape, per_item=1):
        _, heads, tq, tk = shape
        n = self.batch * per_item
        s0, s1 = self.b0 * per_item, self.b1 * per_item
        if tq * tk > FUSED_MIN_LOGITS:
            site = self._site(lambda: _Philox(
                int(torch.randint(0, 2 ** 31 - 1, (), generator=self.gen, device=self.device)),
                self.p, n, heads, tq, tk, self.device))
            return _Tensor(site.full()[s0:s1])
        keep = self._site(lambda: torch.rand((n, heads, tq, tk), generator=self.gen,
                                             device=self.device) >= self.p)
        return _Tensor(keep[s0:s1])
