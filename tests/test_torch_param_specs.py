"""The port's weight sharding (``repro_torch.parallel.sharding``) against
the reference's ``repro.parallel.sharding.param_specs``, on the CPU.

 * For every registered arch, at full size (the reference's tree through
   ``jax.eval_shape``, the port's model built from it on the meta device)
   and at smoke size, the port's ``param_specs`` equals the reference's
   (``tier="pool"``, the engine's, and ``"device"``) leaf by leaf and axis
   by axis, the reference's stacked axes aside; every reference leaf has
   its port parameter.
 * ``shard_params`` at 2 and 4 ranks: each rank holds the contiguous 1/N
   of every leaf with a ``"model"`` axis, the shards put together are the
   whole, and every other leaf is the whole model's own tensor; at full
   width (meta tensors) the rank's bytes are the whole's less (N-1)/N of
   the split leaves'.
"""
import jax
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.parallel import sharding as jsh
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as tsh

ARCHS = sorted(treg.ARCHS)


class _Leaf:
    """A leaf of the reference's shape tree that the bridge can index
    like an array: an index drops the leading axes it takes."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return _Leaf(self.shape[len(idx):])


def _models(arch, size, monkeypatch):
    """(the reference's shape tree, the port's model on the meta device
    built from it) at ``size`` "full" or "smoke"."""
    get = jreg.smoke if size == "smoke" else jreg.get
    cfg = get(arch)
    tree = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    monkeypatch.setattr(bridge, "to_tensor", lambda a, device: torch.empty(
        a.shape, device="meta"))
    leaves = jax.tree_util.tree_map(lambda a: _Leaf(a.shape), tree)
    tcfg = treg.smoke(arch) if size == "smoke" else treg.get(arch)
    return tree, bridge.params_from_jax(leaves, tcfg, device="cpu")


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("tier", ["pool", "device"])
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, size, tier, monkeypatch):
    tree, model = _models(arch, size, monkeypatch)
    want = jsh.param_specs(tree, tier=tier)
    got = tsh.param_specs(model, tier=tier)
    covered = set()
    for name, p in model.named_parameters():
        path, n_idx = tsh.ref_path(name)
        spec = tuple(_at(want, path))
        leaf = _at(tree, path)
        assert tuple(leaf.shape[n_idx:]) == tuple(p.shape), name
        assert spec[:n_idx] == (None,) * n_idx, (name, spec)
        assert got[name] == spec[n_idx:], (name, got[name], spec)
        covered.add(path)
    paths = {jsh._path_str(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert covered == paths
    if size == "full" and tier == "pool":
        assert any("model" in s for s in got.values())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "gemma-2b"])
def test_shards_put_together_are_the_whole(arch, n):
    """Smoke size, real tensors: rank r's leaf is the r-th contiguous 1/N
    of the whole one on its ``"model"`` axis; every other leaf is the
    whole model's tensor itself; the whole model is left as it was."""
    cfg = treg.smoke(arch)
    model = TM.init_model(cfg, seed=3, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    specs = tsh.param_specs(model)
    shards = [tsh.shard_params(model, r, n) for r in range(n)]
    whole = dict(model.named_parameters())
    split = 0
    for r, shard in enumerate(shards):
        assert shard.shard == (r, n)
        assert [k for k, _ in shard.named_parameters()] == list(whole)
    for name, p in whole.items():
        parts = [dict(s.named_parameters())[name] for s in shards]
        if "model" not in specs[name]:
            assert all(q is p for q in parts), name
            continue
        split += 1
        axis = specs[name].index("model")
        assert all(q.shape[axis] * n == p.shape[axis] for q in parts), name
        assert torch.equal(torch.cat(parts, dim=axis), p), name
    assert split > 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "glm4-9b", "starcoder2-15b"])
def test_rank_holds_its_share_at_full_width(arch, n, monkeypatch):
    """Full width, meta tensors: a rank's parameter bytes are the whole
    model's less (N-1)/N of the leaves its spec splits (granite's 49155-row
    table stays whole)."""
    _, model = _models(arch, "full", monkeypatch)
    specs = tsh.param_specs(model)

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())
    split = sum(p.numel() * p.element_size()
                for name, p in model.named_parameters()
                if "model" in specs[name])
    assert split > nbytes(model) // 2
    for r in range(n):
        assert nbytes(tsh.shard_params(model, r, n)) == \
            nbytes(model) - split + split // n
    if arch == "granite-moe-1b-a400m":
        assert specs["embed.embedding"] == (None, "data")
        assert specs["blocks.0.moe.e_gate"] == ("model", "data", None)
