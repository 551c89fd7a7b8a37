"""The port's config editors and merge (`upside_md_torch/config/edit.py`,
`merge.py`) against the JAX package's, on the CPU.

`break_chains` and `add_target_information` are applied by each package
to a copy of one JAX-built file that also holds an /output group written
by the JAX command line's logger (chunked, extensible datasets and an
`invocation` attribute); the edited files must have equal contents as
h5py reads them back (the port rewrites the file, so its datasets are
contiguous).  The same for the `edit` command line, and for
`merge_configs` on JAX-built chain and base files (mirroring
tests/test_config_edit.py and tests/test_merge.py).  An edit that raises
leaves the port's file as it was.
"""

import shutil

import numpy as np
import pytest

from upside_md_torch.config import edit as pe
from upside_md_torch.config import merge as pm
from upside_md_tpu.config import edit as je
from upside_md_tpu.config import merge as jm
from upside_md_tpu.config.builder import ConfigBuilder
from upside_md_tpu.io.logger import H5Logger

from test_torch_builder import assert_same_file, contents

SEQ = "MKVLFEGARTIS"


def _jax_config(tmp_path, name="plain.up", seed=1, hbond=False,
                output=True):
    rng = np.random.default_rng(seed)
    b = ConfigBuilder(f">x\n{SEQ}\n", seed=seed)
    b.add_backbone_springs()
    b.add_rama_map_pot(0.2 * rng.normal(size=(b.n_res, 12, 12)))
    if hbond:
        b.add_hbond(hbond_energy=-2.0)
    path = b.write(str(tmp_path / name))
    if output:
        # what the JAX command line's logger leaves in the file
        with H5Logger(path, invocation="upside sys.up --duration 1") as lg:
            for t in range(7):
                lg.log_frame("pos", b.pos[None] + t)
                lg.log_frame("potential", np.array([1.5 * t]))
                lg.log_frame("time", np.float64(0.027 * t))
    return path, b


def _both(tmp_path, src, name):
    a, b = str(tmp_path / f"jax_{name}.up"), str(tmp_path / f"port_{name}.up")
    shutil.copyfile(src, a)
    shutil.copyfile(src, b)
    return a, b


EDITS = {
    "one_break": dict(chain_first_residue=[6], jump_length_scale=4.0,
                      jump_rotation_scale=25.0),
    "two_breaks_rl": dict(chain_first_residue=[4, 8], rl_chains=[1, 2]),
    "remove_pivot": dict(chain_first_residue=[6], remove_pivot=True),
}


@pytest.mark.parametrize("name", sorted(EDITS))
def test_break_chains_edits_like_jax(tmp_path, name):
    src, _ = _jax_config(tmp_path)
    want, got = _both(tmp_path, src, name)
    kw = dict(EDITS[name])
    breaks = kw.pop("chain_first_residue")
    je.break_chains(want, breaks, **kw)
    pe.break_chains(got, breaks, **kw)
    assert_same_file(got, want)
    # twice over: the second edit replaces the recorded groups
    je.break_chains(want, breaks, jump_length_scale=2.0)
    pe.break_chains(got, breaks, jump_length_scale=2.0)
    assert_same_file(got, want)


def test_add_target_like_jax(tmp_path):
    src, b = _jax_config(tmp_path)
    want, got = _both(tmp_path, src, "target")
    for replace, target in ((False, b.pos + 1.0), (True, b.pos[:, :, None])):
        je.add_target_information(want, target, replace=replace)
        pe.add_target_information(got, target, replace=replace)
        assert_same_file(got, want)
    before = contents(got)
    with pytest.raises(ValueError, match="replace"):
        pe.add_target_information(got, b.pos)
    with pytest.raises(ValueError, match="shape"):
        pe.add_target_information(got, b.pos[:-3], replace=True)
    assert contents(got) == before


def test_refused_edit_leaves_the_file(tmp_path):
    src, _ = _jax_config(tmp_path, hbond=True)
    before = contents(src)
    with pytest.raises(ValueError, match="infer_H_O"):
        pe.break_chains(src, [6])
    with pytest.raises(ValueError, match="rl_chains"):
        pe.break_chains(src, [6], rl_chains=[1, 2])
    assert contents(src) == before
    assert pe.find_multichain_terms(np.array([[0, 1], [17, 18]]),
                                    np.array([0, 18])).tolist() == [
        False, True]


def test_edit_command_line_like_jax(tmp_path):
    src, b = _jax_config(tmp_path)
    want, got = _both(tmp_path, src, "cli")
    tgt = tmp_path / "target.npy"
    np.save(tgt, b.pos)
    for main, path in ((je.main, want), (pe.main, got)):
        main(["break-chains", path, "--chain-first-residue", "6",
              "--remove-pivot"])
        main(["add-target", path, "--target-structure", str(tgt)])
        main(["break-chains", path, "--chain-break-from-file",
              "--jump-length-scale", "3.0"])
    assert_same_file(got, want)


def test_merge_like_jax(tmp_path):
    chains = []
    for i, (seq, seed) in enumerate((("MKVLFE", 1), ("GARTIS", 2))):
        rng = np.random.default_rng(seed)
        c = ConfigBuilder(f">x\n{seq}\n", seed=seed)
        c.add_backbone_springs()
        c.add_rama_map_pot(0.2 * rng.normal(size=(c.n_res, 12, 12)))
        c.add_hbond(hbond_energy=-2.0)
        chains.append((c.write(str(tmp_path / f"c{i}.up")), c))
    base = ConfigBuilder(">x\nMKVLFEGARTIS\n", initial_pos=np.concatenate(
        [chains[0][1].pos, chains[1][1].pos + 30.0]), seed=3)
    base.add_backbone_springs()
    base.add_cavity_radial(60.0)
    base.add_chain_breaks([6])
    base_path = base.write(str(tmp_path / "base.up"))
    paths = [p for p, _ in chains]
    want = jm.merge_configs(base_path, paths, str(tmp_path / "jax.up"))
    got = pm.merge_configs(base_path, paths, str(tmp_path / "port.up"))
    assert_same_file(got, want)
