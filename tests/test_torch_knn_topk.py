"""KNN retrieval's kernels (spml_tpu_torch/csrc/knn_topk.cu through
ops/knn.py::top_k_labels).

On the CPU: the grid plan's invariants, the dispatch (a CPU tensor takes
the plain version and loads no binding; a CUDA tensor, stood in for by a
subclass that reports is_cuda, calls the two C functions with their
signatures' argument counts and no sort, and counts two launches), and
the wrapper's refusals.

Marked gpu (`python -m pytest --noconftest -m gpu
tests/test_torch_knn_topk.py` on a CUDA host; they skip here): the kernels
against the plain version on inputs whose dot products are exact in
float32 (small integers), so that every summation order gives the same
scores and the indices must match exactly, ties and masks included; a
random case at VOC's inference shape that must agree in 99.5% of rows;
the launch count; and the refusals on the card. No JAX here: the CPU
parity with JAX is tests/test_torch_ops.py's.
"""

import math

import numpy as np
import pytest
import torch

from spml_tpu_torch.ops import _cuda, knn
from test_torch_guards import _FakeCuda, _FakeLib


@pytest.mark.parametrize("n,p,k,sms", [(144, 1523808, 20, 132),
                                       (6144, 6144, 5, 132),
                                       (1, 1, 1, 132), (7, 257, 5, 132),
                                       (300, 100003, 32, 132),
                                       (49, 20, 20, 1), (145, 9000, 1, 78)])
def test_plan_covers_the_bank(n, p, k, sms):
    chunks, rows = knn.plan(n, p, k, sms)
    assert rows % knn.BANK_TILE == 0
    assert (chunks - 1) * rows < p <= chunks * rows  # none empty
    assert chunks * k <= knn.MERGE_CAPACITY
    blocks = math.ceil(n / knn.QUERY_TILE) * chunks
    assert blocks <= max(knn.WAVES * knn.BLOCKS_PER_SM * sms,
                         math.ceil(n / knn.QUERY_TILE))


def test_plan_fills_one_wave_at_voc_shape():
    """144 queries in 3 tiles of 48, 88 chunks of 17,408 rows: 264
    blocks, one wave of 2 blocks on each of 132 SMs."""
    chunks, rows = knn.plan(144, 1523808, 20, 132)
    assert (chunks, rows) == (88, 17408)
    assert 3 * chunks == knn.WAVES * knn.BLOCKS_PER_SM * 132


def _case(rng, n=9, p=40, d=8):
    emb = torch.from_numpy(rng.randint(-2, 3, (n, d)).astype(np.float32))
    bank = torch.from_numpy(rng.randint(-2, 3, (p, d)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 5, p))
    mask = torch.from_numpy(rng.rand(p) > 0.3)
    return emb, bank, labels, mask


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def no_binding(name):
        raise AssertionError("the kernel binding was loaded for CPU input")
    monkeypatch.setattr(_cuda, "load", no_binding)
    knn.reset_launch_counts()
    emb, bank, labels, mask = _case(np.random.RandomState(0))
    acc, top = knn.top_k_ranking(emb, labels[:9], bank, labels, 5, None,
                                 mask)
    assert top.shape == (9, 5) and top.dtype == labels.dtype
    assert torch.equal(top, knn.top_k_labels_reference(emb, bank, labels, 5,
                                                       mask))
    assert knn.LAUNCHES == {"knn_topk_partial": 0, "knn_topk_merge": 0}


@pytest.mark.parametrize("masked", [True, False])
def test_cuda_tensor_calls_the_kernels(monkeypatch, masked):
    """Two C calls with their signatures' argument counts (the fake
    library holds them), the planned grid, a scratch of 2 x chunks x N x k
    words, no sort; the launch counters move by one each."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(knn, "_sm_count", lambda device: 132)

    def no_sort(*a, **k):
        raise AssertionError("torch.sort called for a CUDA tensor")
    monkeypatch.setattr(torch, "sort", no_sort)
    knn.reset_launch_counts()
    emb, bank, labels, mask = _case(np.random.RandomState(1), n=50, p=600)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    _, top = knn.top_k_ranking(emb, labels[:50], bank, labels, 20, None,
                               mask if masked else None)
    assert lib.calls == ["knn_topk_partial", "knn_topk_merge"]
    assert top.shape == (50, 20) and top.dtype == torch.int64
    partial, merge = lib.args
    chunks, rows = knn.plan(50, 600, 20, 132)
    # emb, bank, mask, n, p, d, k, chunks, rows, scratch, stream
    assert partial[3:9] == (50, 600, 8, 20, chunks, rows)
    assert (partial[2] is None) == (not masked)
    # scratch, labels, label bytes, n, p, k, chunks, out, stream
    assert merge[0] == partial[9] and merge[2:7] == (8, 50, 600, 20, chunks)
    assert merge[7] == top.data_ptr()
    assert knn.LAUNCHES == {"knn_topk_partial": 1, "knn_topk_merge": 1}


def test_no_queries_launch_nothing(monkeypatch):
    def no_binding(name):
        raise AssertionError("the binding was reached")
    monkeypatch.setattr(_cuda, "load", no_binding)
    knn.reset_launch_counts()
    emb, bank, labels, mask = _case(np.random.RandomState(4), n=0)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    top = knn.top_k_labels(emb, bank, labels, 5, mask)
    assert top.shape == (0, 5) and top.dtype == labels.dtype
    assert knn.LAUNCHES == {"knn_topk_partial": 0, "knn_topk_merge": 0}


def test_launch_error_raises(monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda name: _FakeLib(err=9))
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    monkeypatch.setattr(knn, "_sm_count", lambda device: 132)
    knn.reset_launch_counts()
    emb, bank, labels, mask = _case(np.random.RandomState(2))
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    with pytest.raises(RuntimeError, match="knn_topk_partial"):
        knn.top_k_ranking(emb, labels[:9], bank, labels, 5, None, mask)
    assert knn.LAUNCHES == {"knn_topk_partial": 0, "knn_topk_merge": 0}


def _refusals(emb, bank, labels, mask):
    """(what, call) pairs the wrapper must refuse with ValueError."""
    return [
        ("k above 32", lambda: knn.top_k_labels(emb, bank, labels, 33, mask)),
        ("bank not contiguous", lambda: knn.top_k_labels(
            emb, bank.t().contiguous().t(), labels, 5, mask)),
        ("D not a multiple of 8", lambda: knn.top_k_labels(
            emb[:, :6], bank[:, :6].contiguous(), labels, 5, mask)),
        ("float labels", lambda: knn.top_k_labels(emb, bank, labels.float(),
                                                  5, mask)),
        ("int mask", lambda: knn.top_k_labels(emb, bank, labels, 5,
                                              mask.int())),
        ("D mismatch", lambda: knn.top_k_labels(emb, bank[:, :8], labels,
                                                5, mask)),
    ]


@pytest.mark.parametrize("what", ["k above 32", "bank not contiguous",
                                  "D not a multiple of 8", "float labels",
                                  "int mask", "D mismatch"])
def test_wrapper_refuses(monkeypatch, what):
    def no_binding(name):
        raise AssertionError("the binding was reached")
    monkeypatch.setattr(_cuda, "load", no_binding)
    emb, bank, labels, mask = _case(np.random.RandomState(3), n=9, p=40,
                                    d=16)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    call = dict(_refusals(emb, bank, labels, mask))[what]
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _exact_case(seed, n, p, d, repeat=1, mask="random", labels="index",
                nan=False):
    """Queries and bank of small integers (dot products exact in float32:
    every order of the sums gives the same score, and scores tie often);
    the bank a base of p // repeat rows repeated, so that equal scores lie
    in other tiles and chunks; labels the bank index, or int32 classes;
    nan: query 1 and bank rows 0, p // 2 and p - 1 NaN (a diverged step's
    prototypes), whose scores rank above every number."""
    rng = np.random.RandomState(seed)
    emb = rng.randint(-3, 4, (n, d)).astype(np.float32)
    base = rng.randint(-3, 4, (math.ceil(p / repeat), d)).astype(np.float32)
    bank = np.tile(base, (repeat, 1))[:p]
    if nan:
        emb[1] = np.nan
        bank[[0, p // 2, p - 1]] = np.nan
    if mask == "random":
        m = rng.rand(p) > 0.25
    elif mask == "all":
        m = np.zeros(p, bool)
    elif mask == "few":  # fewer valid prototypes than k
        m = np.zeros(p, bool)
        m[rng.choice(p, 3, replace=False)] = True
    else:
        m = None
    lab = (np.arange(p) if labels == "index"
           else rng.randint(0, 21, p).astype(np.int32))
    return emb, bank, lab, m


EXACT = {  # id -> (n, p, d, k, repeat, mask, labels)
    "k5 ragged": (47, 1001, 16, 5, 1, "random", "index"),
    "k20 ragged": (145, 70003, 64, 20, 1, "random", "index"),
    "k20 ties across chunks": (49, 200000, 64, 20, 4000, "random", "index"),
    "k5 ties no mask": (300, 30000, 32, 5, 7, None, "index"),
    "k1": (33, 5000, 8, 1, 50, "random", "index"),
    "k32 int32 labels": (9, 3000, 24, 32, 3, "random", "int32"),
    "p below k": (5, 19, 16, 20, 1, "random", "index"),
    "fewer valid than k": (17, 4099, 16, 20, 1, "few", "index"),
    "all masked": (17, 2048, 16, 20, 1, "all", "index"),
    "nan query and bank rows": (20, 3000, 16, 20, 1, "random", "index"),
}
NAN_CASE = "nan query and bank rows"


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EXACT))
def test_kernel_equals_sort_on_exact_scores(card, case):
    n, p, d, k, repeat, mask, labels = EXACT[case]
    emb, bank, lab, m = _exact_case(sum(map(ord, case)), n, p, d, repeat,
                                    mask, labels, nan=case == NAN_CASE)
    cpu = [torch.from_numpy(a) if a is not None else None
           for a in (emb, bank, lab, m)]
    gpu = [t.to(card) if t is not None else None for t in cpu]
    q_lab = cpu[2][:n] if n <= p else torch.zeros(n, dtype=cpu[2].dtype)
    knn.reset_launch_counts()
    acc, got = knn.top_k_ranking(gpu[0], q_lab.to(card), gpu[1], gpu[2], k,
                                 None, gpu[3])
    want_acc, want = knn.top_k_ranking(cpu[0], q_lab, cpu[1], cpu[2], k,
                                       None, cpu[3])
    assert knn.LAUNCHES == {"knn_topk_partial": 1, "knn_topk_merge": 1}
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert float(acc) == float(want_acc)


@pytest.mark.gpu
def test_voc_shape_random_rows_agree(card):
    """144 random unit queries against 1,523,808 random unit prototypes,
    D 64, top 20: at least 99.5% of rows equal the plain version's on the
    card (another float32 summation order can swap near-tied neighbours)."""
    gen = torch.Generator(card).manual_seed(7)
    bank = torch.randn(1523808, 64, device=card, generator=gen)
    bank /= bank.norm(dim=1, keepdim=True)
    emb = torch.randn(144, 64, device=card, generator=gen)
    emb /= emb.norm(dim=1, keepdim=True)
    index = torch.arange(bank.shape[0], device=card)
    got = knn.top_k_labels(emb, bank, index, 20)
    want = knn.top_k_labels_reference(emb, bank, index, 20)
    assert float((got == want).all(dim=1).float().mean()) >= 0.995


@pytest.mark.gpu
def test_two_launches_a_call(card):
    emb, bank, lab, m = _exact_case(5, 20, 5000, 16)
    args = [torch.from_numpy(a).to(card) for a in (emb, bank, lab, m)]
    knn.reset_launch_counts()
    for calls in range(1, 4):
        knn.top_k_ranking(args[0], args[2][:20], args[1], args[2], 20, None,
                          args[3])
        assert knn.LAUNCHES == {"knn_topk_partial": calls,
                                "knn_topk_merge": calls}


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["k above 32", "bank not contiguous"])
def test_kernel_refuses_on_the_card(card, what):
    emb, bank, lab, m = _exact_case(6, 9, 400, 16)
    args = [torch.from_numpy(a).to(card) for a in (emb, bank, lab, m)]
    knn.reset_launch_counts()
    with pytest.raises(ValueError):
        dict(_refusals(*args))[what]()
    assert knn.LAUNCHES == {"knn_topk_partial": 0, "knn_topk_merge": 0}
