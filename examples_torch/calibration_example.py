"""Post-hoc calibration of a CNN classifier with last-layer KFAC Laplace.

The PyTorch counterpart of `examples/calibration_example.py`: a LeNet on a
synthetic image task (class-conditional Gaussian blobs, no download),
trained long on few inputs to an overconfident MAP; then last-layer KFAC
Laplace with a marglik-tuned prior and the probit predictive, and the prior
chosen by a gridsearch on held-out NLL instead; accuracy, ECE and NLL of
each.

Run: python examples_torch/calibration_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from laplace_jax_torch import Laplace
from laplace_jax_torch.models.lenet import LeNet
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device
from laplace_jax_torch.utils.metrics import expected_calibration_error, get_nll


def make_synthetic_images(n, num_classes=4, size=16, seed=0):
    """Class-conditional Gaussian-blob 'images' (NHWC) — learnable but noisy."""
    rng = np.random.default_rng(12)
    means = rng.standard_normal((num_classes, size, size, 3)) * 0.22
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=(n,))
    X = means[y] + rng.standard_normal((n, size, size, 3))
    return X.astype(np.float32), y


def train_map(net, loader, device, n_epochs=30, lr=1e-3):
    """Adam on the mean cross-entropy."""
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    for _ in range(n_epochs):
        for x, y in loader:
            x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
            opt.zero_grad()
            loss = torch.nn.functional.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
    return net


def evaluate(probs, targets, name):
    probs = torch.as_tensor(probs).detach().cpu()
    acc = float((probs.argmax(-1).numpy() == np.asarray(targets)).mean())
    ece = expected_calibration_error(probs, targets)
    nll = float(get_nll(probs, torch.as_tensor(targets)))
    row_err = float((probs.double().sum(-1) - 1).abs().max())
    print(f"[{name}] Acc.: {acc:.1%}; ECE: {ece:.1%}; NLL: {nll:.3f}")
    return {"acc": acc, "ece": float(ece), "nll": nll, "row_sum_err": row_err}


def main(device=None, n_train=256, n_test=512, n_val=256, n_epochs=150, grid_size=30):
    device = resolve_device(device)
    # small training set + long training -> an overconfident MAP, the regime
    # where post-hoc Laplace calibration helps
    num_classes = 4
    X_train, y_train = make_synthetic_images(n_train, num_classes)
    X_test, y_test = make_synthetic_images(n_test, num_classes, seed=1)
    train_loader = ArrayLoader(X_train, y_train, batch_size=128, shuffle=True)

    net = LeNet(num_classes, in_channels=3, image_size=16,
                generator=torch.Generator().manual_seed(0)).to(device)
    net = train_map(net, train_loader, device, n_epochs=n_epochs, lr=2e-3)
    out = {}

    with torch.no_grad():
        probs_map = torch.softmax(net(torch.as_tensor(X_test, device=device)), -1)
    out["MAP"] = evaluate(probs_map, y_test, "MAP")

    # last-layer KFAC Laplace with a marglik-tuned prior
    la = Laplace(net, "classification", subset_of_weights="last_layer",
                 hessian_structure="kron", device=device)
    la.fit(ArrayLoader(X_train, y_train, batch_size=128))
    la.optimize_prior_precision(method="marglik")
    probs_laplace = la(X_test, link_approx="probit")
    out["marglik"] = evaluate(probs_laplace, y_test, "Laplace (LL-KFAC, probit, marglik)")

    # alternative: gridsearch the prior on held-out NLL
    X_val, y_val = make_synthetic_images(n_val, num_classes, seed=2)
    la.optimize_prior_precision(
        method="gridsearch", val_loader=ArrayLoader(X_val, y_val, batch_size=128),
        grid_size=grid_size, log_prior_prec_min=-2, log_prior_prec_max=4)
    probs_grid = la(X_test, link_approx="probit")
    out["gridsearch"] = evaluate(probs_grid, y_test, "Laplace (LL-KFAC, probit, gridsearch)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
