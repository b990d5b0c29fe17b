"""Closed loop, one client: full-batch GCN training steps, each waited for,
as OGB's example script trains ogbn-products (one step an epoch, no
evaluation between them).

One request is one step: ``zero_grad``, the forward over every node
(``GCN(X)``, dropout in training mode), ``nll_loss`` of ``log_softmax``
over the training nodes, the backward and ``Adam.step``, timed by
``calls.Stopwatch`` up to the synchronize after it.  The configuration's
``model`` gives the widths, the dropout, Adam's settings and the training
nodes (in proportion to ``nodes``, so that a cut graph keeps the share);
``spmv_config`` and ``pack`` are what the user passes to ``GCN``.  The
traffic file gives ``warm_up`` steps and ``trace_requests`` (the steps of
the traced stretch).

The generated directed edges become an undirected adjacency on the card:
both directions, distinct entries, no self-loops, unit values; the GCN
gets it raw and normalizes it itself (``normalize=True``).  Features
N(0, 1), labels uniform over the classes, the training split and the
dropout masks' generator come from the run's seed; the weights from the
GCN's own ``seed``, drawn from it.

Each step also keeps what the check needs of every backward product of
``Â`` (``_Catch``, hooks on the GCN's ``DiffSpmm``): its input ``G`` at
the rows that the product's output reads at ``GRAD_PROBE`` nodes, and that
output there.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench_h100.gen import train_work
from bench_h100.gen.matrices import _to_host, generator, subseed
from bench_h100.reference import gcn as ref_gcn

from .calls import Stopwatch, sync

# nodes whose logits an answer keeps for the check
PROBE = 4096
# nodes (of the PROBE) at which an answer keeps each backward product
GRAD_PROBE = 1024


def undirected(csr, device):
    """The undirected graph of ``csr``'s entries on ``device``: each edge
    in both directions, once, without self-loops, values 1; a host
    ``Csr``."""
    n = csr.num_rows
    indptr = torch.as_tensor(csr.indptr, device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   indptr[1:] - indptr[:-1])
    cols = torch.as_tensor(csr.indices, device=device).long()
    off = rows != cols
    rows, cols = rows[off], cols[off]
    key = torch.unique(torch.cat([rows * n + cols, cols * n + rows]))
    del rows, cols, off
    return _to_host(n, n, key // n, key % n,
                    torch.ones(key.numel(), dtype=torch.float32,
                               device=device))


def column_rows(csr, nodes, device):
    """The rows that ``(A + I)``'s columns ``nodes`` hold entries in, for
    ``csr``'s ``A``: those whose ``G`` rows the rows ``nodes`` of ``Â^T
    G`` read; sorted, on ``device``."""
    n = csr.num_rows
    indptr = torch.as_tensor(csr.indptr, device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device),
                                   indptr[1:] - indptr[:-1])
    hit = torch.isin(torch.as_tensor(csr.indices, device=device).long(),
                     nodes)
    return torch.unique(torch.cat([rows[hit], nodes]))


class _Catch:
    """Hooks on the GCN's aggregation (a ``DiffSpmm``) that keep, for each
    backward product ``Â^T G`` of a step, ``G`` at the rows ``need`` and
    the product at the rows ``probe``, by the index of the aggregation in
    the forward.  The product is the gradient of the aggregation's input,
    which ``gcn_apply_fn`` hands to nothing else."""

    def __init__(self, probe, need):
        self.probe, self.need = probe, need
        self.start()

    def start(self) -> None:
        self.calls, self.caught = 0, {}

    def _put(self, i: int, what: str, rows) -> None:
        self.caught.setdefault(i, {})[what] = rows

    def pre(self, module, args) -> None:
        i, X = self.calls, args[0]
        self.calls += 1
        if torch.is_tensor(X) and X.requires_grad:
            X.register_hook(lambda g: self._put(
                i, "out", g.index_select(0, self.probe)))

    def post(self, module, args, Y) -> None:
        i = self.calls - 1
        if Y.requires_grad:
            Y.register_hook(lambda G: self._put(
                i, "G", G.index_select(0, self.need)))


class Cell:
    def __init__(self, config: dict, traffic: dict, csr, seed: int,
                 device):
        self.config, self.traffic = config, traffic
        self.device = dev = torch.device(device)
        model = config["model"]
        self.dims = list(model["dims"])
        self.p = float(model["dropout"])
        self.adam = dict(lr=float(model["lr"]),
                         betas=tuple(model["betas"]), eps=float(model["eps"]))
        self.csr = undirected(csr, dev)
        n = self.csr.num_rows
        self.X = torch.randn(n, self.dims[0], generator=generator(
            seed, "features", dev), device=dev)
        self.labels = torch.randint(0, self.dims[-1], (n,),
                                    generator=generator(seed, "labels", dev),
                                    device=dev)
        k = round(model["train_nodes"] * n / model["nodes"])
        self.train_idx = torch.sort(torch.randperm(n, generator=generator(
            seed, "split", dev), device=dev)[:k]).values
        self.weight_seed = subseed(seed, "weights")
        self.masks = generator(seed, "dropout", dev)
        # the nodes whose logits, and of those the nodes whose backward
        # products, each answer keeps
        perm = torch.randperm(n, generator=generator(seed, "probe", dev),
                              device=dev)
        self.probe = torch.sort(perm[:PROBE]).values
        self.grad_probe = torch.sort(perm[:GRAD_PROBE]).values
        self.catch = _Catch(self.grad_probe, column_rows(
            self.csr, self.grad_probe, dev))
        # Â's entries: the adjacency's and a self-loop a node
        self.nnz_hat = self.csr.nnz + n
        self.flops = train_work.step_flops(n, self.nnz_hat, self.dims)
        # a step's useful sparse operations, what ``readers.gops`` counts
        self.ops = train_work.spmm_ops(self.nnz_hat, self.dims)
        self.model = self.opt = self._logits = None
        self.step = 0
        self.watch = Stopwatch(dev)

    def prepare(self) -> None:
        """From the CSR adjacency in host memory to the GCN and its
        optimizer on the card: normalization, the symmetry check, the pack,
        its plans and the upload."""
        from hisparse_tpu_torch import CSRMatrix, GCN, SpmvConfig
        c = self.csr
        m = CSRMatrix(c.num_rows, c.num_cols, c.data, c.indices, c.indptr)
        self.model = GCN(m, self.dims,
                         SpmvConfig(**self.config["spmv_config"]),
                         device=self.device, normalize=True,
                         seed=self.weight_seed, dropout=self.p,
                         **self.config["pack"])
        self.model.train()
        self.model.agg.register_forward_pre_hook(self.catch.pre)
        self.model.agg.register_forward_hook(self.catch.post)
        self.opt = torch.optim.Adam(self.model.parameters(), **self.adam)
        sync(self.device)

    def counters(self) -> dict:
        agg = self.model.agg
        out = {"fill": agg.wp.fill, "main_tiles": agg.wp.num_tiles,
               "packs": 1 if agg.opT is agg.op else 2,
               "flops_step": self.flops}
        if self.device.type == "cuda":
            from bench_h100.gen import work
            out["fp32_peak_ops_per_s"] = work.peaks(
                torch.cuda.get_device_name(self.device))["fp32_ops_per_s"]
        return out

    def _params(self):
        """The parameters in layer order, each layer's weight then bias."""
        return [v for prm in self.model.params() for v in (prm["w"],
                                                           prm["b"])]

    def _key(self):
        """The step index, the parameters and Adam's state before the step,
        and the dropout generator's state."""
        ps = self._params()
        st = [self.opt.state[p] for p in ps]
        return {"step": self.step,
                "params": [p.detach().clone() for p in ps],
                "exp_avg": [s["exp_avg"].clone() if s else torch.zeros_like(p)
                            for s, p in zip(st, ps)],
                "exp_avg_sq": [s["exp_avg_sq"].clone() if s
                               else torch.zeros_like(p)
                               for s, p in zip(st, ps)],
                "adam_step": [int(s["step"]) if s else 0 for s in st],
                "masks": self.masks.get_state()}

    def _train_step(self):
        self.catch.start()
        self.opt.zero_grad()
        logits = self.model(self.X, generator=self.masks)
        self._logits = logits.detach()
        loss = torch.nn.functional.nll_loss(
            torch.log_softmax(logits, dim=-1)[self.train_idx],
            self.labels[self.train_idx])
        loss.backward()
        self.opt.step()
        return loss

    def request(self, i: int):
        """One step, waited for: ``(key, answer, ops, enqueue seconds,
        seconds)``; the answer holds the loss, the probe nodes' logits, the
        gradients and the parameters after the step, cloned outside the
        timed span, and each backward product's rows (``_Catch``)."""
        key = self._key()
        loss, enq, secs = self.watch.time(self._train_step)
        ps = self._params()
        out = {"loss": loss.detach().clone(),
               "logits": self._logits[self.probe],
               "grads": [p.grad.detach().clone() for p in ps],
               "params": [p.detach().clone() for p in ps],
               "agg_grad": self.catch.caught}
        self.catch.caught = {}
        self._logits = None
        self.step += 1
        return key, out, self.ops, enq, secs

    def bound_s(self, peak: dict, requests) -> float:
        """The least seconds the card could take for the steps' products of
        ``Â``."""
        return len(requests) * train_work.spmm_bound_s(
            self.csr.num_rows, self.nnz_hat, self.dims, peak)

    def warm_up(self) -> None:
        for i in range(int(self.traffic["warm_up"])):
            self.request(i)

    def release(self) -> None:
        self.model = self.opt = None

    def check(self, samples) -> list:
        """The worst normwise error of each kept step against the float64
        reference on the adjacency this driver built, each over the size
        its float32 rounding scales with: the loss's, over the loss; the
        probe nodes' logits', over the logits; each gradient's, over the
        gradient of the same terms by their absolute values
        (``reference/gcn.grad_scales``: over the gradient itself the
        measure grows without bound as training on random labels cancels
        every gradient toward 0); and the Adam update's (float64 Adam on
        the program's own gradients and saved state, against the
        program's parameter change), over the parameters' size and the
        update's; and each backward product's rows at the probe nodes,
        over ``Â^T G`` in float64 on the program's own ``G``."""
        c = self.csr
        adj = ref_gcn.Adjacency(c.num_rows, c.indptr, c.indices, c.data,
                                self.device)
        X = self.X.double()
        return [self._check_one(adj, X, key, out) for key, out in samples]

    def _check_one(self, adj, X, key, out) -> float:
        return max(self.errors(adj, X, key, out).values())

    def errors(self, adj, X, key, out) -> dict:
        """Each compared number of one kept step, by name."""
        f64 = torch.float64
        g = torch.Generator(device=self.device)
        g.set_state(key["masks"])
        n = len(self.dims) - 1
        params = [{"w": key["params"][2 * i], "b": key["params"][2 * i + 1]}
                  for i in range(n)]
        ref = ref_gcn.loss_and_grads(adj, params, X, self.labels,
                                     self.train_idx, self.p, g)
        flat = [v for gr in ref["grads"] for v in (gr["w"], gr["b"])]
        size = [v for sc in ref["scales"] for v in (sc["w"], sc["b"])]
        names = [f"{k}{i}" for i in range(n) for k in "wb"]
        errs = {"loss": rel(out["loss"], ref["loss"]),
                "logits": rel(out["logits"], ref["logits"][self.probe])}
        for i, got in sorted(out["agg_grad"].items()):
            errs[f"agg_grad{i}"] = rel(got["out"], ref_gcn.transposed_rows(
                adj, self.grad_probe, self.catch.need, got["G"]))
        for j, p0 in enumerate(key["params"]):
            errs["grad_" + names[j]] = rel(out["grads"][j], flat[j], size[j])
            p0 = p0.to(f64)
            new, _, _ = ref_gcn.adam(
                p0, out["grads"][j].to(f64), key["exp_avg"][j].to(f64),
                key["exp_avg_sq"][j].to(f64), key["adam_step"][j],
                **self.adam)
            errs["adam_" + names[j]] = rel(
                out["params"][j].to(f64) - p0, new - p0,
                p0.abs() + (new - p0).abs())
        return errs


def rel(a, b, size=None) -> float:
    """``|a - b| / |size|`` (``size`` b by default) in the Frobenius norm,
    in float64; a NaN is infinite, and so is any gap over a size of norm
    0."""
    a = a.detach().to(b.device, torch.float64)
    if a.shape != b.shape:
        return float("inf")
    gap = float((a - b).norm())
    den = float((b if size is None else size).norm())
    if np.isnan(gap):
        return float("inf")
    if den == 0:
        return 0.0 if gap == 0 else float("inf")
    return gap / den


def bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


class _Bf16Control(Cell):
    """The step with TF32 projections allowed and each aggregation's input
    rounded to bfloat16, forward (X) and backward (G) (``DiffSpmm``
    refuses a bf16 pack)."""

    def prepare(self) -> None:
        super().prepare()
        self.model.agg.register_forward_pre_hook(_round_input)
        self.model.agg.register_forward_hook(_round_grad)

    def _train_step(self):
        with _tf32():
            return super()._train_step()


def _round_input(module, args):
    """X rounded in the forward; its gradient passes as it is."""
    X = args[0]
    return (X + (bf16(X) - X).detach(),)


def _round_grad(module, args, Y):
    """G, the backward product's input, rounded."""
    if Y.requires_grad:
        Y.register_hook(bf16)


@contextlib.contextmanager
def _tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def control_spec(spec):
    """The control (``control.py``): the same cell, stepped by
    :class:`_Bf16Control`."""
    return spec, _Bf16Control
