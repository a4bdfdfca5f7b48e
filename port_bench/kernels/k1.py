"""Work of one launch of K1 (the fused conv segment's forward, kept
residual): the stem conv (H·W·9·C1 multiply-adds an image) and conv2
((H/2)·(W/2)·9·C1·C2); bytes: the image, the weights and biases in the
compute dtype, the pooled output and its one-byte window index."""


def work(clients, batch, H, W, C1, C2, elt=2):
    n = clients * batch
    flops = 2.0 * n * (H * W * 9 * C1 + (H // 2) * (W // 2) * 9 * C1 * C2)
    pooled = n * (H // 4) * (W // 4) * C2
    weights = clients * (9 * C1 + C1 + 9 * C1 * C2 + C2)
    nbytes = n * H * W * elt + weights * elt + pooled * elt + pooled
    return flops, nbytes
