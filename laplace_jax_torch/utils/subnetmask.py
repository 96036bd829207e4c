"""Subnetwork selection strategies (port of `laplace_jax/utils/subnetmask.py`).

Each mask selects an index vector into the canonical flat parameter vector
(`utils/flatten.py`). Score-based masks rank the parameters and keep the
top k, with the JAX package's numpy call on a numpy copy of the scores
(`np.argsort` is not stable, and torch breaks ties differently, so the same
scores give the same indices in both packages). Name-based masks select
whole leaves or modules by their flax paths: a parameter is
`"Dense_0/kernel"` (the JAX package's `"params/Dense_0/kernel"` is taken
too), a module `"Dense_0"` or `"ResidualBlock_0/Conv_0"`.

A mask runs its model on `device`: CUDA unless the caller passes
`device="cpu"`.
"""

from __future__ import annotations

import numpy as np

from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import NNModel, batch_slice
from laplace_jax_torch.utils.device import resolve_device, to_device

__all__ = [
    "SubnetMask",
    "RandomSubnetMask",
    "LargestMagnitudeSubnetMask",
    "LargestVarianceDiagLaplaceSubnetMask",
    "LargestVarianceSWAGSubnetMask",
    "ParamNameSubnetMask",
    "ModuleNameSubnetMask",
    "LastLayerSubnetMask",
]


def _param_name(name: str) -> str:
    return name[len("params/"):] if name.startswith("params/") else name


class SubnetMask:
    """Base class (reference `subnetmask.py:28-155`); `model` is an
    `nn.Module`, moved to `device`."""

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        self.model = NNModel(model.to(self.device))
        self.parameter_vector = self.model.mean_vector
        self._n_params = int(self.parameter_vector.shape[0])
        self._indices: np.ndarray | None = None
        self._n_params_subnet: int | None = None

    def _check_select(self):
        if self._indices is None:
            raise AttributeError("Subnetwork mask not selected. Run select() first.")

    @property
    def indices(self) -> np.ndarray:
        self._check_select()
        return self._indices

    @property
    def n_params_subnet(self) -> int:
        if self._n_params_subnet is None:
            self._check_select()
            self._n_params_subnet = len(self._indices)
        return self._n_params_subnet

    def convert_subnet_mask_to_indices(self, subnet_mask) -> np.ndarray:
        """A binary (n_params,) mask as a sorted index vector (reference
        `subnetmask.py:64-112`)."""
        mask = np.asarray(subnet_mask)
        if mask.dtype not in (np.bool_,) and not np.issubdtype(mask.dtype, np.integer):
            raise ValueError("Subnetwork mask needs to be 1-dimensional integral or boolean!")
        if mask.ndim != 1 or len(mask) != self._n_params:
            raise ValueError("Subnetwork mask needs to be a binary (n_params,) vector!")
        if not np.isin(mask.astype(np.int64), [0, 1]).all():
            raise ValueError("Subnetwork mask must be binary!")
        return np.nonzero(mask)[0]

    def select(self, train_loader=None) -> np.ndarray:
        if self._indices is not None:
            raise ValueError("Subnetwork mask already selected.")
        self._indices = self.convert_subnet_mask_to_indices(self.get_subnet_mask(train_loader))
        return self._indices

    def get_subnet_mask(self, train_loader):
        raise NotImplementedError


class ScoreBasedSubnetMask(SubnetMask):
    """The top k by score (reference `subnetmask.py:158-205`)."""

    def __init__(self, model, n_params_subnet: int, device=None):
        super().__init__(model, device)
        if n_params_subnet is None:
            raise ValueError("Need to pass number of subnetwork parameters when using "
                             "subnetwork Laplace.")
        if n_params_subnet > self._n_params:
            raise ValueError(f"Subnetwork ({n_params_subnet}) cannot be larger than model "
                             f"({self._n_params}).")
        self._n_params_subnet = n_params_subnet
        self._param_scores = None

    def compute_param_scores(self, train_loader):
        raise NotImplementedError

    def _check_param_scores(self):
        if np.shape(self._param_scores) != tuple(self.parameter_vector.shape):
            raise ValueError("Parameter scores need to be of same shape as parameter vector.")

    def get_subnet_mask(self, train_loader):
        if self._param_scores is None:
            self._param_scores = self.compute_param_scores(train_loader)
        self._check_param_scores()
        # the JAX package's call on the numpy scores: the same ties broken alike
        idx = np.argsort(np.asarray(self._param_scores))[::-1][: self._n_params_subnet]
        mask = np.zeros(self._n_params, dtype=bool)
        mask[idx] = True
        return mask


class RandomSubnetMask(ScoreBasedSubnetMask):
    """A uniformly random subnetwork (reference `subnetmask.py:208-212`)."""

    def __init__(self, model, n_params_subnet, seed: int = 0, device=None):
        super().__init__(model, n_params_subnet, device)
        self.seed = seed

    def compute_param_scores(self, train_loader):
        return np.random.default_rng(self.seed).uniform(size=self._n_params)


class LargestMagnitudeSubnetMask(ScoreBasedSubnetMask):
    """The largest |θ| (reference `subnetmask.py:215-219`)."""

    def compute_param_scores(self, train_loader):
        return np.abs(self.parameter_vector.cpu().numpy())


class LargestVarianceDiagLaplaceSubnetMask(ScoreBasedSubnetMask):
    """The largest marginal variances under `diag_laplace_model`, an
    all-weights `DiagLaplace` that `select` fits (reference
    `subnetmask.py:222-249`)."""

    def __init__(self, model, n_params_subnet, diag_laplace_model, device=None):
        super().__init__(model, n_params_subnet, device)
        self.diag_laplace_model = diag_laplace_model

    def compute_param_scores(self, train_loader):
        if train_loader is None:
            raise ValueError("Need to pass train loader for subnet selection.")
        self.diag_laplace_model.fit(train_loader)
        return self.diag_laplace_model.posterior_variance.cpu().numpy()


class LargestVarianceSWAGSubnetMask(ScoreBasedSubnetMask):
    """The largest marginal variances under diagonal SWAG
    (`utils/swag.fit_diagonal_swag_var`; reference `subnetmask.py:252-307`)."""

    def __init__(self, model, n_params_subnet, likelihood=Likelihood.CLASSIFICATION,
                 swag_n_snapshots: int = 40, swag_snapshot_freq: int = 1,
                 swag_lr: float = 0.01, device=None):
        if likelihood not in (Likelihood.CLASSIFICATION, Likelihood.REGRESSION):
            raise ValueError("Only available for classification and regression!")
        super().__init__(model, n_params_subnet, device)
        self.likelihood = likelihood
        self.swag_n_snapshots = swag_n_snapshots
        self.swag_snapshot_freq = swag_snapshot_freq
        self.swag_lr = swag_lr

    def compute_param_scores(self, train_loader):
        if train_loader is None:
            raise ValueError("Need to pass train loader for subnet selection.")
        from laplace_jax_torch.utils.swag import fit_diagonal_swag_var

        return fit_diagonal_swag_var(
            self.model, train_loader, self.likelihood, n_snapshots_total=self.swag_n_snapshots,
            snapshot_freq=self.swag_snapshot_freq, lr=self.swag_lr,
            device=self.device).cpu().numpy()


class ParamNameSubnetMask(SubnetMask):
    """Whole parameter leaves by flax path, e.g. `"Dense_0/kernel"`
    (reference `subnetmask.py:310-350`)."""

    def __init__(self, model, parameter_names: list[str], device=None):
        super().__init__(model, device)
        self._parameter_names = parameter_names

    def _check_param_names(self):
        names = {_param_name(n) for n in self._parameter_names}
        if not names:
            raise ValueError("Parameter name list cannot be empty.")
        missing = names - {"/".join(s.path) for s in self.model.leaf_specs}
        if missing:
            raise ValueError(f"Parameters {sorted(missing)} do not exist in model.")

    def get_subnet_mask(self, train_loader):
        self._check_param_names()
        names = {_param_name(n) for n in self._parameter_names}
        mask = np.zeros(self._n_params, dtype=bool)
        for s in self.model.leaf_specs:
            if "/".join(s.path) in names:
                mask[s.offset : s.offset + s.size] = True
        return mask


class ModuleNameSubnetMask(SubnetMask):
    """Whole modules by flax path, e.g. `"Dense_0"` (a module's own leaves,
    not its submodules'; reference `subnetmask.py:353-404`)."""

    def __init__(self, model, module_names: list[str], device=None):
        super().__init__(model, device)
        self._module_names = module_names

    def _module_leaves(self, name: str):
        mpath = tuple(name.split("/"))
        return [s for s in self.model.leaf_specs if s.path[:-1] == mpath]

    def get_subnet_mask(self, train_loader):
        if not list(self._module_names):
            raise ValueError("Module name list cannot be empty.")
        for name in self._module_names:
            if not self._module_leaves(name):
                raise ValueError(f"Modules ['{name}'] do not exist in model.")
        mask = np.zeros(self._n_params, dtype=bool)
        for name in self._module_names:
            for s in self._module_leaves(name):
                mask[s.offset : s.offset + s.size] = True
        return mask


class LastLayerSubnetMask(ModuleNameSubnetMask):
    """The last layer as the subnetwork (reference `subnetmask.py:407-436`);
    with no `last_layer_name`, the last Dense layer executed on the first
    training input."""

    def __init__(self, model, last_layer_name: str | None = None, device=None):
        super().__init__(model, [], device)
        self._last_layer_name = last_layer_name

    def get_subnet_mask(self, train_loader):
        if train_loader is None:
            raise ValueError("Need to pass train loader for subnet selection.")
        if self._last_layer_name is None:
            data = next(iter(train_loader))
            X = data[0] if isinstance(data, (tuple, list)) else data
            X = to_device(batch_slice(X, slice(0, 1)), self.device, self.parameter_vector.dtype)
            self._module_names = ["/".join(self.model.find_last_layer(X))]
        else:
            self._module_names = [self._last_layer_name]
        return super().get_subnet_mask(train_loader)
