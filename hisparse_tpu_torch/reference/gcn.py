"""The plain reference of a full-batch GCN training step: OGB's
ogbn-products "Full-batch GCN" (``examples/nodeproppred/products/gnn.py``:
3 GCNConv layers of hidden width 256, relu and dropout after each hidden
layer, ``log_softmax`` and ``nll_loss`` over the training nodes, Adam).

Plain ``torch`` in float32 or float64, with TF32 off for its matrix
products; it imports no JAX and nothing of the port.  One step:

  * :class:`Adjacency`: ``Â = D^-1/2 (A + I) D^-1/2`` from a CSR adjacency
    (PyG's ``gcn_norm`` with self-loops, cached once as OGB caches it),
    and ``Â^T``, as sparse CSR tensors;
  * :func:`forward`: every layer in the published order ``Â (H W) + b``;
  * :func:`loss_and_grads`: the loss and the parameters' gradients by
    autograd (the aggregation's backward is ``Â^T G``);
  * :func:`adam`: one Adam step by its formula.

Departures from the published model, each the same mathematics or the
same distribution:

  * dropout draws float32 uniforms ``u`` with ``torch.rand`` from a
    ``torch.Generator``, in layer order, and keeps ``h`` where ``u >= p``
    (``F.dropout`` draws its Bernoulli mask from the global generator), so
    that a step's masks can be drawn again from a saved generator state;
  * the port orders layers 1 and 2 as ``(Â H) W`` (narrow side first),
    which this file does not;
  * the parameters are whatever the caller gives (the port draws them He
    scaled, PyG Glorot's), and OGB's periodic evaluation forward is left
    out.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _csr(rows, cols, vals, n):
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, (n, n),
                                  check_invariants=False)
    return coo.coalesce().to_sparse_csr()


class Adjacency:
    """``Â`` and ``Â^T`` in ``dtype`` on ``device``, from an (n, n) CSR
    adjacency ``(indptr, indices, data)``: self-loops added to it (a
    diagonal entry already there is summed with its loop), degrees the
    row sums of ``A + I``, and ``Â_ij = d_i^-1/2 A_ij d_j^-1/2`` formed in
    ``dtype``."""

    def __init__(self, n: int, indptr, indices, data, device,
                 dtype=torch.float64):
        indptr = torch.as_tensor(indptr, dtype=torch.int64, device=device)
        rows = torch.repeat_interleave(torch.arange(n, device=device),
                                       indptr[1:] - indptr[:-1])
        cols = torch.as_tensor(indices, device=device).long()
        vals = torch.as_tensor(data, device=device).to(dtype)
        loop = torch.arange(n, device=device)
        rows, cols = torch.cat([rows, loop]), torch.cat([cols, loop])
        vals = torch.cat([vals, torch.ones(n, dtype=dtype, device=device)])
        deg = torch.zeros(n, dtype=dtype, device=device).index_add_(
            0, rows, vals)
        dinv = torch.where(deg > 0, deg.clamp_min(1e-300).rsqrt(), 0.0)
        vals = dinv[rows] * vals * dinv[cols]
        self.n, self.dtype = n, dtype
        self.nnz = rows.numel()
        self.A = _csr(rows, cols, vals, n)
        self.AT = _csr(cols, rows, vals, n)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, adj):
        ctx.adj = adj
        return adj.A @ H

    @staticmethod
    def backward(ctx, G):
        return ctx.adj.AT @ G, None


def dropout(h: torch.Tensor, p: float, generator: torch.Generator):
    """``h`` kept where a float32 uniform of the generator is ``>= p``,
    scaled by ``1 / (1 - p)``."""
    u = torch.rand(h.shape, generator=generator, dtype=torch.float32,
                   device=h.device)
    return h * (u >= p) / (1.0 - p)


def forward(adj: Adjacency, params, X, p: float = 0.0, generator=None):
    """The logits: ``Â (H W) + b`` a layer, relu and (with a generator and
    ``p`` > 0) dropout after each hidden layer.  ``params`` is
    ``[{'w', 'b'}, ...]`` in ``adj.dtype``."""
    h = X
    for i, prm in enumerate(params):
        h = _Aggregate.apply(h @ prm["w"], adj) + prm["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
            if generator is not None and p > 0:
                h = dropout(h, p, generator)
    return h


def loss_and_grads(adj: Adjacency, params, X, labels, train_idx,
                   p: float = 0.0, generator=None):
    """``(loss, grads)``: ``nll_loss`` of ``log_softmax`` over all nodes,
    read at ``train_idx``, and its gradient in each parameter, as
    ``[{'w', 'b'}, ...]``; the parameters are detached copies in
    ``adj.dtype``."""
    with no_tf32():
        ps = [{k: v.detach().to(adj.dtype).clone().requires_grad_(True)
               for k, v in prm.items()} for prm in params]
        logits = forward(adj, ps, X.to(adj.dtype), p, generator)
        logp = torch.log_softmax(logits, dim=-1)
        loss = torch.nn.functional.nll_loss(logp[train_idx],
                                            labels[train_idx])
        flat = [v for prm in ps for v in (prm["w"], prm["b"])]
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                           for i in range(len(ps))]


def adam(param, grad, exp_avg, exp_avg_sq, step: int, lr: float,
         betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam step (Kingma & Ba, as ``torch.optim.Adam`` without weight
    decay or amsgrad): ``step`` is the count before it; returns
    ``(param, exp_avg, exp_avg_sq)`` after it."""
    b1, b2 = betas
    t = step + 1
    m = b1 * exp_avg + (1 - b1) * grad
    v = b2 * exp_avg_sq + (1 - b2) * grad * grad
    m_hat = m / (1 - b1 ** t)
    v_hat = v / (1 - b2 ** t)
    return param - lr * m_hat / (v_hat.sqrt() + eps), m, v
