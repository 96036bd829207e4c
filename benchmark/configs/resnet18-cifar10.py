"""Plain forward of ResNet-18 in its CIFAR-10 form (He et al. 2016,
arXiv:1512.03385, section 4.2's CIFAR variant at ImageNet ResNet-18's
widths 64/128/256/512): a 3x3 stem, four stages of two basic blocks with a
1x1 projection where the shape changes, global average pooling, a dense
head. Departure from the paper, as the configuration states: no norm
layers. Returns the logits and the head's input features."""


def forward(ops, x):
    x = ops.relu(ops.conv("Conv_0", ops.nchw(x)))
    b = 0
    while f"ResidualBlock_{b}.Conv_0" in ops.layers:
        p = f"ResidualBlock_{b}"
        y = ops.conv(f"{p}.Conv_1", ops.relu(ops.conv(f"{p}.Conv_0", x)))
        residual = ops.conv(f"{p}.Conv_2", x) if f"{p}.Conv_2" in ops.layers else x
        x = ops.relu(residual + y)
        b += 1
    phi = ops.global_mean(x)
    return ops.dense("Dense_0", phi), phi
