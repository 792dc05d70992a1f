"""Segment formation over height shards (spml_tpu_torch/ops/kmeans.py,
ops/common.py::resize_labels), in one process, without a process group:

* the compaction merge, by hypothesis over each rank's keys and validity
  (overflow at the capacity, keys shared by ranks, a rank with no valid
  pixel): each rank's first `capacity` unique keys
  (local_unique_keys), merged (merge_unique_keys), give each rank's
  pixels (ids_from_unique_keys) the ids and keep of
  compact_unique_segments on the joined keys, exactly;
* the labels resized on a shard from global coordinates (its rows of
  the output's partition, the source rows fetched from the ranks that
  own them) equal the rows of the whole image's resize, and at the
  network's ratio of 8 on even shards the rank's own (local) resize; the
  k-means grid's global rows differ from a grid over a shard's own
  height;
* a float64 simulation of segment_batch over S = 2, 3 and 4 space ranks
  (3: 16 rows as 5/5/6):
  one thread a rank, parallel/mesh.py's gather_stack and group_sum
  replaced by their one-process counterparts (each rank's partial
  sums added in rank order): the Segments joined from the ranks equal
  the whole images', every field exactly, with overflow at a small
  capacity and a shard whose labels are all the ignore index; and over
  images of fewer rows than ranks (2 rows over 4 and 3, 3 over 4, 1 over
  3), where a rank holds no pixel: it still enters every M-step sum, the
  key merge and the attribute max, and ends with no pixel fields and
  the images' segment fields.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from spml_tpu_torch.ops import common, kmeans
from spml_tpu_torch.parallel import halo, mesh as mesh_lib


@settings(max_examples=60, deadline=None)
@given(data=st.data(), space=st.integers(1, 4),
       capacity=st.integers(1, 12), n=st.integers(1, 16))
def test_merge_of_rank_lists_equals_compaction(data, space, capacity, n):
    keys = data.draw(st.lists(st.lists(st.integers(0, 20), min_size=n,
                                       max_size=n),
                              min_size=space, max_size=space))
    valid = data.draw(st.lists(st.lists(st.booleans(), min_size=n,
                                        max_size=n),
                               min_size=space, max_size=space))
    if data.draw(st.booleans()):  # a rank with no valid pixel
        valid[data.draw(st.integers(0, space - 1))] = [False] * n
    keys, valid = torch.tensor([keys]), torch.tensor([valid])  # [1, S, n]
    lists = torch.stack([kmeans.local_unique_keys(keys[:, r], valid[:, r],
                                                  capacity)
                         for r in range(space)])
    merged = kmeans.merge_unique_keys(lists, capacity)
    want_ids, want_keep = kmeans.compact_unique_segments(
        keys.reshape(1, -1), valid.reshape(1, -1), capacity)
    for r in range(space):
        ids, keep = kmeans.ids_from_unique_keys(keys[:, r], valid[:, r],
                                                merged, capacity)
        part = slice(r * n, (r + 1) * n)
        assert torch.equal(ids, want_ids[:, part]), (r, ids, want_ids)
        assert torch.equal(keep, want_keep[:, part]), (r, keep, want_keep)


def test_merge_keeps_the_first_capacity_keys():
    lists = torch.tensor([[[1, 4, 9]], [[2, 4, 5]],
                          [[kmeans.INVALID_KEY] * 3]])
    assert kmeans.merge_unique_keys(lists, 3).tolist() == [[1, 2, 4]]
    assert kmeans.merge_unique_keys(lists[1:], 3).tolist() == [[2, 4, 5]]
    assert kmeans.local_unique_keys(
        torch.tensor([[7, 3, 7, 1, 3]]), torch.tensor([[1, 1, 1, 0, 1]]) > 0,
        3).tolist() == [[3, 7, kmeans.INVALID_KEY]]


@pytest.mark.parametrize("space", [2, 4, 3])
@pytest.mark.parametrize("size,out", [((32, 24), (4, 3)),
                                      ((64, 40), (16, 10)),
                                      ((24, 20), (8, 7))])
def test_resize_labels_on_shards(space, size, out):
    from test_torch_sp_halo import _sharded_rows

    if size[0] % space:
        size = (size[0] // space * space, size[1])
    labels = torch.from_numpy(np.random.RandomState(0).randint(
        0, 200, (2, *size)))
    whole = common.resize_labels(labels, out)
    got = _sharded_rows(labels[:, None], space, lambda rows, height:
                        common.resize_labels(rows[:, 0], out,
                                             height)[:, None])[:, 0]
    assert torch.equal(got, whole)
    if size[0] == 8 * out[0] and out[0] % space == 0:
        # the network's ratio: the rank's own rows, resized locally
        h, oh = size[0] // space, out[0] // space
        for s in range(space):
            assert torch.equal(got[:, s * oh:(s + 1) * oh],
                               common.resize_labels(
                                   labels[:, s * h:(s + 1) * h],
                                   (oh, out[1])))


def test_grid_rows_are_the_global_grid_s():
    grid = kmeans.initialize_cluster_labels((6, 6), (64, 16))
    top = kmeans.initialize_cluster_labels((6, 6), (32, 16))
    assert not torch.equal(grid[:32], top)  # a shard's own grid is wrong
    assert grid[:32, 0].unique().tolist() == [0, 1, 2]
    assert grid[32:, 0].unique().tolist() == [3, 4, 5]


class _Group:
    """A space group of threads: stack() is gather_stack."""

    def __init__(self, n):
        self.barrier, self.slots = threading.Barrier(n), [None] * n

    def stack(self, rank, x):
        self.slots[rank] = x.detach().clone()
        self.barrier.wait()
        out = torch.stack(self.slots)
        self.barrier.wait()
        return out


@dataclasses.dataclass(frozen=True)
class _ThreadMesh(mesh_lib.Mesh):
    group: _Group = None

    def space_group(self):
        return (self.group, self.space_rank)


def _gather_stack(x, group):
    g, rank = group
    return g.stack(rank, x)


def _group_sum(x, group):
    parts = _gather_stack(x, group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def _inputs(b, h, w, d, seed, ignore_rows=None):
    rng = np.random.RandomState(seed)
    emb = torch.from_numpy(rng.randn(b, h, w, d))
    loc = common.generate_location_features(h, w).double()
    loc = loc.expand(b, h, w, 2)
    sem = torch.from_numpy(rng.choice([0, 1, 2, 3, 255], (b, h, w)))
    inst = torch.from_numpy(rng.randint(0, 3, (b, h, w)))
    if ignore_rows is not None:
        sem[:, ignore_rows] = 255
    return emb, loc, sem, inst


@pytest.mark.parametrize("space,capacity,ignore", [
    (2, 32, None), (4, 32, None), (2, 6, None), (2, 32, slice(0, 8)),
    (3, 32, None)])
def test_sharded_segment_batch_equals_whole_images(monkeypatch, space,
                                                   capacity, ignore):
    """float64, where k-means has no near-ties: the ranks' Segments are
    the whole images' (pixel fields joined by rows, segment fields the
    same on every rank)."""
    got, want = _segments_over_ranks(monkeypatch, space, capacity, ignore,
                                     16)
    if ignore is not None:  # rank 0 holds no valid pixel, and still ids
        assert not got[0].pixel_valid.any() and want.segment_valid.any()
    if capacity < 32:  # some pixels overflow
        assert not want.pixel_valid.all() and want.segment_valid.all()


@pytest.mark.parametrize("space,h", [(4, 2), (4, 3), (3, 2), (3, 1)])
def test_sharded_segment_batch_with_ranks_without_rows(monkeypatch, space,
                                                       h):
    """float64 images of fewer rows than space ranks: the ranks without
    a row hold no pixel fields, and every rank the whole images'
    segments."""
    got, want = _segments_over_ranks(monkeypatch, space, 32, None, h)
    sizes = [g.pixel_segment_ids.shape[1] for g in got]
    assert 0 in sizes and sum(sizes) == want.pixel_segment_ids.shape[1]
    assert want.segment_valid.any()


def _segments_over_ranks(monkeypatch, space, capacity, ignore, h):
    """segment_batch over `space` thread ranks of 3 images h x 8 against
    one process: (each rank's Segments, the whole images'), every field
    asserted equal (pixel fields joined by rows)."""
    b, w = 3, 8
    emb, loc, sem, inst = _inputs(b, h, w, 8, 1, ignore)
    args = ((2, 2), capacity, 3, 255)
    want = kmeans.segment_batch(emb, loc, sem, inst, *args)[0]
    monkeypatch.setattr(mesh_lib, "gather_stack", _gather_stack)
    monkeypatch.setattr(mesh_lib, "group_sum", _group_sum)
    group, got, errors = _Group(space), [None] * space, []
    parts = halo.partition(h, space)

    def rank(s):
        try:
            mesh = _ThreadMesh(s, space, space, group)
            part = slice(parts[s].start, parts[s].stop)
            got[s] = kmeans.segment_batch(
                emb[:, part], loc[:, part], sem[:, part], inst[:, part],
                *args, mesh=mesh, rows=h)[0]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(s,))
               for s in range(space)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for f, name in enumerate(kmeans.Segments._fields):
        if name.startswith("pixel"):
            joined = torch.cat([g[f].reshape(b, len(p), w)
                                for g, p in zip(got, parts)], 1)
            assert torch.equal(joined.reshape(b, -1), want[f]), name
        else:
            for g in got:
                assert torch.equal(g[f], want[f]), name
    return got, want
