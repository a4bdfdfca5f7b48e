"""Work of one launch of K2 (the fused conv segment's backward from the
pooled gradient and the window index), counted low where it depends on
the data: FLOPs only of the stem's weight gradient ((H/2)·(W/2)·9·C1
multiply-adds an image), none of the conv2 products, which run over the
routed non-zeros; bytes: the image, the weights in the compute dtype, the
pooled gradient and the index, and the f32 weight gradients."""


def work(clients, batch, H, W, C1, C2, elt=2):
    n = clients * batch
    flops = 2.0 * n * (H // 2) * (W // 2) * 9 * C1
    pooled = n * (H // 4) * (W // 4) * C2
    weights = clients * (9 * C1 + C1 + 9 * C1 * C2 + C2)
    nbytes = (n * H * W * elt + weights * elt + pooled * elt + pooled
              + 4 * weights)
    return flops, nbytes
