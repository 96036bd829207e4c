"""`bench.py`'s reward-model transformer (`reward_ll_fit`, `bench.py:396-410`)
in flax and its torch twin (`tests/torch_reward_twin.py`), at any width,
for the port's parity tests.

The flax module is `bench.py`'s with its sizes as fields; `reward_pair`
initializes it, casts the parameters to float64 and loads them into the
twin with `state_dict_from_flax`.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np

from laplace_jax_torch.models.resnet import state_dict_from_flax

from .torch_reward_twin import RewardTransformer

NARROW = dict(vocab=64, d=16, heads=2, mlp=32, blocks=2)  # sequences of 8 tokens


class FlaxRewardTransformer(fnn.Module):
    vocab: int = 4096
    d: int = 256
    heads: int = 8
    mlp: int = 1024
    blocks: int = 4

    @fnn.compact
    def __call__(self, ids):
        x = fnn.Embed(self.vocab, self.d)(ids)
        for _ in range(self.blocks):
            a = fnn.MultiHeadDotProductAttention(num_heads=self.heads, qkv_features=self.d,
                                                 deterministic=True)(x)
            x = fnn.LayerNorm()(x + a)
            h = fnn.Dense(self.mlp)(x)
            h = jax.nn.gelu(h)
            h = fnn.Dense(self.d)(h)
            x = fnn.LayerNorm()(x + h)
        return fnn.Dense(2)(x.mean(axis=1))


def reward_pair(seed=0, n=16, seq=8, sizes=NARROW):
    """(ids (n, seq), labels (n,), flax module, float64 flax params, float64
    torch twin with the same weights)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, sizes["vocab"], size=(n, seq))
    y = rng.integers(0, 2, size=n)
    fm = FlaxRewardTransformer(**sizes)
    params = fm.init(jax.random.key(seed), jnp.asarray(ids[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    tm = RewardTransformer(**sizes).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return ids, y, fm, params, tm


def n_weights(vocab, d, heads, mlp, blocks) -> int:
    """The twin's weight count (4,208,130 at `bench.py`'s sizes)."""
    block = 4 * (d * d + d) + 2 * 2 * d + (d * mlp + mlp) + (mlp * d + d)
    return vocab * d + blocks * block + 2 * d + 2

