"""Operations and bytes of the model's layers, from their shapes alone.

A matrix product of (m, k) by (k, n) is 2 m n k operations; normalisations,
activations, softmax and gathers are not counted. The counts are of the
mathematics each layer needs, whatever implements it: the patch embed's
concat is counted as the fused kernel computes it (the global half once a
group), attention over a sequence of L tokens counts all L x L scores, also
where a mask hides some. Nothing computed twice (recomputation) is counted.
"""

from __future__ import annotations

FP32 = 4


def dense(rows: float, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def block(length: int, dim: int, mlp_ratio: float = 4.0) -> float:
    """One pre-norm transformer block's forward over one sequence: qkv,
    scores, attend, projection and the MLP."""
    hidden = int(dim * mlp_ratio)
    return (dense(length, dim, 3 * dim) + 4.0 * length * length * dim
            + dense(length, dim, dim) + dense(length, dim, hidden) + dense(length, hidden, dim))


def attention_sublayer(length: int, dim: int, backward: bool) -> float:
    """The fused attention sublayer (qkv, scores, attend, projection) over
    one sequence. Forward 8 L D^2 + 4 L^2 D: qkv 6 L D^2, scores and attend
    2 L^2 D each, projection 2 L D^2. Backward from dy 16 L D^2 + 8 L^2 D:
    dWproj and dO (2 L D^2 each), dP, dV, dQ and dK (2 L^2 D each), dWqkv
    and dx (6 L D^2 each); the forward's products that the kernel computes
    again are not counted."""
    ld2, l2d = length * dim * dim, length * length * dim
    return 16.0 * ld2 + 8.0 * l2d if backward else 8.0 * ld2 + 4.0 * l2d


def attention_bytes(batch: int, length: int, dim: int, backward: bool,
                    qkv_bias: bool = False) -> float:
    """Bytes the fused attention sublayer must move: x (and dy) read, y (and
    dx) written once, the weights read (and their gradients written) once."""
    weights = (3 * dim * dim + (3 * dim if qkv_bias else 0) + dim * dim + dim) * FP32
    x = batch * length * dim * FP32
    return 3 * x + 2 * weights if backward else 2 * x + weights


def pos_embed(rows: float, dim: int) -> float:
    """The positional MLP 3 -> 128 -> dim."""
    return dense(rows, 3, 128) + dense(rows, 128, dim)


def patch_embed(groups: float, group_size: int, out_dim: int) -> float:
    """The mini-PointNet over ``groups`` groups: per point 3->128, 128->256,
    the second conv's point half 256->512 and 512->out; per group the
    concat's global half 256->512 once."""
    per_point = 3 * 128 + 128 * 256 + 256 * 512 + 512 * out_dim
    return groups * (2.0 * group_size * per_point + 2.0 * 256 * 512)


def patch_embed_bytes(groups: int, group_size: int, out_dim: int) -> float:
    """Points read, tokens written and the weights read once."""
    weights = (3 * 128 + 128 + 128 * 256 + 256 + 512 * 512 + 512 + 512 * out_dim + out_dim
               + 2 * (128 + 512)) * FP32
    return groups * group_size * 3 * FP32 + groups * out_dim * FP32 + weights
