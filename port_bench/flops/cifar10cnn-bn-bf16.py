"""Model FLOPs of CIFAR10CNN (frozen yardstick): six SAME 3x3
convolutions, two at each of three resolutions, and three dense layers; a
multiply-add is 2 FLOPs; normalization, pooling and activations are left
out. Training counts the forward and the backward once an example, 3x the
forward, with no recomputation."""


def forward_flops_per_example(config) -> float:
    H, W, cin = config["input_shape"]
    total = 0
    for i, c in enumerate(config["conv_channels"]):
        s = 2 ** (i // 2)
        total += (H // s) * (W // s) * 9 * cin * c
        cin = c
    flat = (H // 8) * (W // 8) * cin
    for n in list(config["dense_sizes"]) + [config["num_classes"]]:
        total += flat * n
        flat = n
    return 2.0 * total


def train_flops_per_example(config) -> float:
    return 3.0 * forward_flops_per_example(config)
