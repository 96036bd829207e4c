"""Plain forward of WideResNet-16-4 (Zagoruyko & Komodakis 2016,
arXiv:1605.07146; depth 16, widen factor 4, widths 16/64/128/256), the
CIFAR-10 model of Laplace Redux (arXiv:2106.14806), in inference mode: a
3x3 stem and its batch norm, three stages of two wide blocks (conv, norm,
ReLU, conv, norm, plus the identity or a 1x1 projection, ReLU), global
average pooling, a dense head. Departure, as the configuration states:
the block convs carry biases. Returns the logits and the head's input
features."""


def forward(ops, x):
    x = ops.relu(ops.batchnorm("BatchNorm_0", ops.conv("Conv_0", ops.nchw(x))))
    b = 0
    while f"WideBlock_{b}.Conv_0" in ops.layers:
        p = f"WideBlock_{b}"
        h = ops.relu(ops.batchnorm(f"{p}.BatchNorm_0", ops.conv(f"{p}.Conv_0", x)))
        y = ops.batchnorm(f"{p}.BatchNorm_1", ops.conv(f"{p}.Conv_1", h))
        residual = ops.conv(f"{p}.Conv_2", x) if f"{p}.Conv_2" in ops.layers else x
        x = ops.relu(residual + y)
        b += 1
    phi = ops.global_mean(x)
    return ops.dense("Dense_0", phi), phi
