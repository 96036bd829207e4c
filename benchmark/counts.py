"""The yardstick's operation and byte counts, and the card's peaks.

Every count is worked out from a configuration's layer table alone
(`configs/<name>.json`, `layers`), so a new configuration needs no new
code. Each is a lower bound on the work of what it counts: an
implementation that does more work reads a lower share, none can read
over 100%.
"""

from __future__ import annotations

# NVIDIA's H100 SXM data sheet, dense rates: float32 outside the tensor
# cores (the configurations run float32 with TF32 off), HBM3 bandwidth.
# Both assume the card's full 700 W limit; the result states the limit.
PEAK_FLOPS_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12
BYTES_F32 = 4


def out_hw(e: dict) -> int:
    """A conv's output size along one axis ('SAME': ceil(n / stride))."""
    return -(-e["hw"] // e["stride"])


def positions(e: dict) -> int:
    """Output positions of a layer per input: T of the KFAC factors."""
    return out_hw(e) ** 2 if e["kind"] == "conv" else 1


def a_dim(e: dict) -> int:
    """The activation factor's size: a conv's patch, a dense layer's input."""
    return e["c_in"] * e["k"] ** 2 if e["kind"] == "conv" else e["c_in"]


def tapped(config: dict) -> list:
    return [e for e in config["layers"] if e["kind"] in ("conv", "dense")]


def forward_flops(config: dict) -> float:
    """FLOPs of one input's forward: 2 per multiply-add of every conv and
    dense layer. Biases, norms, activations and pooling are left out (a
    lower bound)."""
    return sum(2.0 * a_dim(e) * e["c_out"] * positions(e) for e in tapped(config))


def sweep_flops(config: dict) -> float:
    """FLOPs of one cotangent sweep of one input, from the output back to
    the first layer's output: each later layer's input gradient, which
    costs as many multiply-adds as its forward. The first layer, which
    reads the network's input, needs none."""
    layers = tapped(config)
    return sum(2.0 * a_dim(e) * e["c_out"] * positions(e) for e in layers[1:])


def gram_flops(rows: float, d: int) -> float:
    """FLOPs of a Gram's lower triangle over `rows` rows of size d: d(d+1)/2
    entries, a multiply and an add each per row."""
    return rows * d * (d + 1.0)


def factor_sizes(config: dict) -> list:
    """The size of every factor a KFAC posterior eigendecomposes: each
    kernel's A and B. A bias's factor is its layer's B again, so it is not
    counted twice."""
    out = []
    for e in tapped(config):
        out += [a_dim(e), e["c_out"]]
    return out


def eigh_flops(n: int) -> float:
    """FLOPs of one n x n symmetric eigendecomposition without its
    tridiagonal solve: 4/3 n^3 to tridiagonalize, 2 n^3 to apply the
    reflectors to the tridiagonal's eigenvectors. The tridiagonal solve is
    not counted, as its cost depends on deflation."""
    return 4.0 / 3.0 * n ** 3 + 2.0 * n ** 3


def kfac_fit_flops(config: dict, n_inputs: int) -> float:
    """FLOPs an all-weights exact-Fisher KFAC fit of `n_inputs` inputs
    needs: one forward and C cotangent sweeps per input, each tapped
    layer's A Gram over its patch rows and its B Gram over each sweep's
    output rows, and each factor's eigendecomposition."""
    C = config["num_classes"]
    total = n_inputs * (forward_flops(config) + C * sweep_flops(config))
    for e in tapped(config):
        rows = n_inputs * positions(e)
        total += gram_flops(rows, a_dim(e)) + C * gram_flops(rows, e["c_out"])
    return total + sum(eigh_flops(n) for n in factor_sizes(config))


def ll_variance_flops(config: dict) -> float:
    """FLOPs of one input's last-layer GLM output variances under a KFAC
    posterior, in the factors' eigenbases: the features into A's eigenbasis
    (2 d^2), their squares against the inverse eigenvalues (2 d C), then
    into B's (2 C^2)."""
    head = tapped(config)[-1]
    d, C = head["c_in"], head["c_out"]
    return 2.0 * d * d + 2.0 * d * C + 2.0 * C * C


def factor_classes(config: dict) -> dict:
    """{n: K}: how many factors of each size a KFAC fit eigendecomposes
    (each kernel's A and B, and each bias's B again)."""
    out: dict = {}
    for e in tapped(config):
        sizes = [a_dim(e), e["c_out"]] + ([e["c_out"]] if e.get("bias") else [])
        for n in sizes:
            out[n] = out.get(n, 0) + 1
    return out


def stage1_least_seconds(K: int, n: int) -> tuple:
    """The least time the stage-1 panel kernels can take on a (K, n)
    stack, and which bound sets it ("operations" or "bytes").

    Operations: each Householder column j needs the product of the
    trailing (n - 1 - j)-square matrix with its reflector, 2 (n - 1 - j)^2
    FLOPs, summed over the n - 2 columns (about 2/3 n^3). The other half of
    stage 1's 4/3 n^3, the trailing rank-2nb updates, runs in cuBLAS
    outside the panel kernels, so it is left out of both this count and
    the time it is held to.
    Bytes: each matrix read once, its reflectors (the strict lower
    triangle), diagonal, off-diagonal and scales written once."""
    flops = K * sum(2.0 * m * m for m in range(2, n))
    nbytes = K * BYTES_F32 * (n * n + n * (n - 1) / 2 + 3 * n)
    t_ops, t_bytes = flops / PEAK_FLOPS_F32, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
