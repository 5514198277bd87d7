"""Cross-rank primitives on a block-split learner axis.

Under ``torchrun`` (one process a rank, W ranks) the global learner stack
(L, ...) is cut into W contiguous blocks of L/W learners: rank r holds
learners [r·L/W, (r+1)·L/W) of every stacked leaf.  Each function here
takes this rank's block and returns what the one-process op returns on
the global stack, restricted to the block, with the same bits:

* :func:`roll_learners` — ``torch.roll(global, shift, 0)``: the rows
  that cross a block boundary travel by ``batch_isend_irecv``, one
  message a (sender, receiver) pair, for any shift (the exponential
  graph's 2^k can exceed L/W);
* :func:`gather_learners` — the global stack, in learner order;
* :func:`ordered_sum_learners` — ``mixing.ordered_sum(global, 0)``, the
  sum in learner order: rank 0 adds its rows in order and sends the
  partial to rank 1, which adds its own, and so on; the last rank
  broadcasts the total.  An all-reduce would add in another order.

A coded payload is several tensors a row (an int8 row and its
buckets' f32 scales): :func:`pack_rows` lays each row's bytes of them
side by side in one uint8 row, so that a row travels as one message
through any of the above, and :func:`unpack_rows` takes them apart where
it arrives.

With no process group (W = 1) each is the plain torch op it replaces,
and no ``torch.distributed`` call is made.  ``sent_bytes`` counts the
payload bytes this rank has sent, by primitive (a broadcast's root
counts one payload a receiver).

Payloads travel in their own dtype (a bf16 leaf's neighbours move as
bf16, as the reference's collective-permute moves them).  NCCL moves
CUDA tensors card to card; gloo's point-to-point takes CPU tensors, so
under gloo a CUDA payload is staged through host memory explicitly
(:func:`staged`), which is what lets two ranks share one card.
"""
from __future__ import annotations

import torch

sent_bytes = {"roll": 0, "gather": 0, "sum": 0}


def reset_sent() -> None:
    """Set every ``sent_bytes`` count to 0."""
    for k in sent_bytes:
        sent_bytes[k] = 0


def _count(kind: str, t: torch.Tensor, copies: int = 1) -> torch.Tensor:
    sent_bytes[kind] += copies * t.numel() * t.element_size()
    return t


def world() -> tuple:
    """(rank, world size) of an initialised process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def learner_block(n_learners: int) -> tuple:
    """(start, count): this rank's contiguous block of ``n_learners``
    global learners; ValueError unless the world size divides it."""
    rank, W = world()
    if n_learners % W:
        raise ValueError(f"{n_learners} learners do not split over {W} "
                         f"ranks: the world size must divide the learner "
                         f"count")
    per = n_learners // W
    return rank * per, per


def global_count(local: int) -> int:
    """The global size of a block-split axis whose block has ``local``
    rows (every rank holds the same count)."""
    return local * world()[1]


def block_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global stack ``x`` (L, ...): the rows
    [r·L/W, (r+1)·L/W), a view."""
    start, count = learner_block(x.shape[0])
    return x.narrow(0, start, count)


def staged(x: torch.Tensor) -> bool:
    """Whether a payload of ``x`` goes through host memory: a CUDA tensor
    under gloo, whose point-to-point and broadcast take CPU tensors."""
    return x.is_cuda and torch.distributed.get_backend() == "gloo"


def _out(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a payload to send: contiguous, on the host when staged."""
    x = x.detach().contiguous()
    return x.cpu() if staged(x) else x


def _buffer(shape, like: torch.Tensor) -> torch.Tensor:
    """A receive buffer for a payload of ``like``'s dtype and device (the
    host when staged)."""
    dev = "cpu" if staged(like) else like.device
    return torch.empty(tuple(shape), dtype=like.dtype, device=dev)


def _runs(rows):
    """Maximal runs of consecutive indices in ``rows``: [(first, count)]."""
    runs = []
    for r in rows:
        if runs and runs[-1][0] + runs[-1][1] == r:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((r, 1))
    return runs


def _take(x: torch.Tensor, rows) -> torch.Tensor:
    """Rows ``rows`` of ``x`` in order, as slices of its runs (a view
    where they form one run)."""
    parts = [x.narrow(0, a, n) for a, n in _runs(rows)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _p2p(ops) -> None:
    """Start the point-to-point ops together and wait for every one."""
    for req in torch.distributed.batch_isend_irecv(ops):
        req.wait()


def roll_learners(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(global, shift, 0)`` restricted to this rank's block:
    local row j (global g = r·n + j) becomes global row (g - shift) mod
    L.  The source rows of a block lie in at most two blocks; each pair
    of ranks exchanges at most one message, of contiguous rows."""
    rank, W = world()
    if W == 1:
        return torch.roll(x, shift, dims=0)
    dist = torch.distributed
    n = x.shape[0]
    L = n * W

    def sources(dst):                  # global source row of each row
        return [(dst * n + j - shift) % L for j in range(n)]

    ops, inbox = [], []
    for dst in range(W):
        if dst == rank:
            continue
        rows = [g - rank * n for g in sources(dst) if g // n == rank]
        if rows:
            payload = _count("roll", _out(_take(x, rows)))
            ops.append(dist.P2POp(dist.isend, payload, dst))
    src = sources(rank)
    by_rank = {}
    for j, g in enumerate(src):
        by_rank.setdefault(g // n, []).append(j)
    for s, js in by_rank.items():
        if s != rank:
            buf = _buffer((len(js),) + tuple(x.shape[1:]), x)
            ops.append(dist.P2POp(dist.irecv, buf, s))
            inbox.append((js, buf))
    if ops:
        _p2p(ops)
    # the local block's rows land in runs of consecutive output rows, as
    # do each received payload's
    out = torch.empty_like(x)
    mine = by_rank.get(rank, [])
    pieces = [(mine, _take(x, [src[j] - rank * n for j in mine]))] \
        if mine else []
    pieces += [(js, buf.to(x.device)) for js, buf in inbox]
    for js, part in pieces:
        at = 0
        for first, count in _runs(js):
            out.narrow(0, first, count).copy_(part.narrow(0, at, count))
            at += count
    return out


def gather_learners(x: torch.Tensor) -> torch.Tensor:
    """The global stack (L, ...) from every rank's block, in learner
    order, on ``x``'s device."""
    rank, W = world()
    if W == 1:
        return x
    dist = torch.distributed
    payload = _count("gather", _out(x), W - 1)
    parts = [torch.empty_like(payload) for _ in range(W)]
    dist.all_gather(parts, payload)
    return torch.cat([p.to(x.device) for p in parts], dim=0)


def _ordered(x: torch.Tensor, total=None):
    """``total`` (None: nothing yet) plus the rows of ``x`` one at a time,
    in order: the reference's reduction order."""
    for i in range(x.shape[0]):
        row = x.select(0, i)
        total = row if total is None else total + row
    return total


def ordered_sum_learners(x: torch.Tensor) -> torch.Tensor:
    """``mixing.ordered_sum(global, 0)`` on every rank, bit for bit: a
    chain from rank 0 to rank W-1 carries the partial sum (in the rows'
    dtype), each rank adding its rows in order; the last rank broadcasts
    the total."""
    rank, W = world()
    if W == 1:
        return _ordered(x)
    dist = torch.distributed
    partial = None
    if rank > 0:
        buf = _buffer(x.shape[1:], x)
        _p2p([dist.P2POp(dist.irecv, buf, rank - 1)])
        partial = buf.to(x.device)
    total = _ordered(x, partial)
    if rank < W - 1:
        _p2p([dist.P2POp(dist.isend, _count("sum", _out(total)), rank + 1)])
        total = _buffer(x.shape[1:], x)
    else:
        total = _count("sum", _out(total), W - 1)
    dist.broadcast(total, W - 1)
    return total.to(x.device)


def pack_rows(*parts: torch.Tensor) -> torch.Tensor:
    """One uint8 payload (n, bytes) of tensors that share their leading
    rows: row i holds the bytes of row i of every part, in order."""
    return torch.cat([p.contiguous().reshape(p.shape[0], -1).view(
        torch.uint8) for p in parts], dim=1)


def unpack_rows(buf: torch.Tensor, likes) -> list:
    """The parts of a :func:`pack_rows` payload: ``likes`` gives each
    part's (dtype, shape of one row), in the packing order."""
    out, at = [], 0
    for dtype, shape in likes:
        nbytes = int(torch.Size(shape).numel()) * dtype.itemsize
        part = buf[:, at:at + nbytes].contiguous().view(dtype)
        out.append(part.reshape((buf.shape[0],) + tuple(shape)))
        at += nbytes
    return out


def ordered_sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of one tensor each, in rank order, on every
    rank (the chain of :func:`ordered_sum_learners` with one row a
    rank)."""
    return ordered_sum_learners(x.unsqueeze(0))


def local_block(tree):
    """This rank's block of every tensor leaf of a global learner-stacked
    tree (dicts, tuples, lists; other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: local_block(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(local_block(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        return block_rows(tree).clone()
    return tree


def gather_tree(tree, device=None):
    """Every tensor leaf of a block-split tree gathered into the global
    stack (on ``device``, default the leaf's own), one leaf at a time."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        full = gather_learners(tree)
        return full if device is None else full.to(device)
    return tree
