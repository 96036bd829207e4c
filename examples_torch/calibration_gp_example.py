"""Calibration with FunctionalLaplace (GP predictive) at growing subset sizes.

The PyTorch counterpart of `examples/calibration_gp_example.py`: the LeNet
of `calibration_example.py` on its synthetic image task, then last-layer
Laplace with `hessian_structure="gp"` and the GP probit predictive for
subsets of data of 50, 100 and 200 inputs; accuracy, ECE and NLL of each.

Run: python examples_torch/calibration_gp_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from examples_torch.calibration_example import evaluate, make_synthetic_images, train_map
from laplace_jax_torch import Laplace
from laplace_jax_torch.models.lenet import LeNet
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device


def main(device=None, n_train=512, n_test=256, n_epochs=20, n_subsets=(50, 100, 200)):
    device = resolve_device(device)
    num_classes = 4
    X_train, y_train = make_synthetic_images(n_train, num_classes)
    X_test, y_test = make_synthetic_images(n_test, num_classes, seed=1)
    train_loader = ArrayLoader(X_train, y_train, batch_size=64, shuffle=True)

    net = LeNet(num_classes, in_channels=3, image_size=16,
                generator=torch.Generator().manual_seed(0)).to(device)
    net = train_map(net, train_loader, device, n_epochs=n_epochs)
    out = {}

    with torch.no_grad():
        probs_map = torch.softmax(net(torch.as_tensor(X_test, device=device)), -1)
    out["MAP"] = evaluate(probs_map, y_test, "MAP")

    # last-layer GP Laplace with growing subset-of-data sizes
    for n_subset in n_subsets:
        la = Laplace(net, "classification", subset_of_weights="last_layer",
                     hessian_structure="gp", n_subset=n_subset, device=device)
        la.fit(ArrayLoader(X_train, y_train, batch_size=64))
        probs = la(X_test, pred_type="gp", link_approx="probit")
        out[f"gp_{n_subset}"] = evaluate(probs, y_test, f"GP Laplace (n_subset={n_subset})")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
