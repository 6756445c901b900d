"""Protein-guided extension (guidedassembleresult) in the port:
stages/guided_assembly.py against the JAX package's on the cases of
tests/test_guided_assembly.py and on seeded worlds of overlapping
fragments with stop codons, and the `guidedassembleresult` subcommand of
both CLIs on the same DBs (every output byte equal)."""
import numpy as np
import pytest

from carpedeam_tpu import cli as jax_cli
from carpedeam_tpu.io.seqdb import SeqDB as JaxSeqDB
from carpedeam_tpu.kmer.matcher import kmermatcher as jax_kmermatcher
from carpedeam_tpu.stages import guided_assembly as JG
from carpedeam_tpu.stages.rescorediagonal import \
    rescorediagonal as jax_rescorediagonal
from carpedeam_tpu_torch import cli
from carpedeam_tpu_torch.aligndb import AlnDB
from carpedeam_tpu_torch.io.seqdb import SeqDB
from carpedeam_tpu_torch.kmer.matcher import kmermatcher
from carpedeam_tpu_torch.stages import guided_assembly as G
from carpedeam_tpu_torch.stages.rescorediagonal import rescorediagonal
from torch_port_util import guided_world, same_outputs, same_seqs, translate


def _both(seqs, seq_id_thr=0.9, max_seq_len=300000):
    """(port out_n, out_a), (JAX out_n, out_a) on the same fragments: each
    package builds its own DBs and alignments (kmermatcher k=20, then
    rescorediagonal at seqId 0.9)."""
    aa = [translate(s) for s in seqs]
    nucl, prot = SeqDB.from_sequences(seqs), SeqDB.from_sequences(aa)
    aln = rescorediagonal(nucl, kmermatcher(nucl, 20, 200, 0.2, False), 0.9)
    jn, ja = JaxSeqDB.from_sequences(seqs), JaxSeqDB.from_sequences(aa)
    jaln = jax_rescorediagonal(jn, jax_kmermatcher(jn, 20, 200, 0.2, False),
                               seq_id_thr=0.9)
    return (G.guided_assembly(nucl, prot, aln, seq_id_thr, max_seq_len),
            JG.guided_assembly(jn, ja, jaln, seq_id_thr, max_seq_len))


def _assert_equal(mine, ref):
    for m, r in zip(mine, ref):
        assert same_seqs(m, r)
        assert np.array_equal(m.ext, r.ext)


def test_guided_extension_merges_overlaps():
    """tests/test_guided_assembly.py's first case: two halves of a
    stop-free genome extend to the whole genome."""
    rng = np.random.default_rng(11)
    genome = "".join("ACG"[b] for b in rng.integers(0, 3, 120))
    mine, ref = _both([genome[:60], genome[30:]])
    _assert_equal(mine, ref)
    out_n, out_a = mine
    assert any(out_n.seq_str(i) == genome for i in range(2) if out_n.ext[i])
    j = [i for i in range(2) if out_n.ext[i]][0]
    assert out_a.ext[j]


def test_guided_extension_blocked_by_stop_codon():
    """tests/test_guided_assembly.py's second case: a query ending in a
    stop codon is not right-extended."""
    rng = np.random.default_rng(12)
    core = "".join("ACG"[b] for b in rng.integers(0, 3, 57))
    a = core + "TAA"
    b = core[27:] + "TAA" + "".join("ACG"[x] for x in rng.integers(0, 3, 27))
    assert translate(a)[-1] == "*"
    mine, ref = _both([a, b])
    _assert_equal(mine, ref)
    assert mine[0].seq_str(0) == a or not mine[0].ext[0]


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("max_seq_len", [300000, 220])
def test_guided_assembly_matches_jax_on_seeded_worlds(seed, max_seq_len):
    """About 20 overlapping fragments, a quarter with a stop codon at the
    start and a quarter at the end; at max_seq_len 220 some extensions
    would pass the limit.  Both output DBs equal the JAX package's."""
    mine, ref = _both(guided_world(seed), max_seq_len=max_seq_len)
    _assert_equal(mine, ref)
    assert mine[0].ext.any()
    assert max(int(x) for x in mine[0].lengths) < max_seq_len


def test_guidedassembleresult_cli_matches_jax(tmp_path):
    """The subcommand on saved DBs in both CLIs: both output DBs' files
    equal."""
    seqs = guided_world(7, n=24)
    SeqDB.from_sequences(seqs).save(str(tmp_path / "nucl"))
    SeqDB.from_sequences([translate(s) for s in seqs]).save(
        str(tmp_path / "aa"))
    nucl = SeqDB.load(str(tmp_path / "nucl"))
    rescorediagonal(nucl, kmermatcher(nucl, 20, 200, 0.2, False), 0.9) \
        .save(str(tmp_path / "aln"))
    ins = [str(tmp_path / n) for n in ("nucl", "aa", "aln")]
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        (tmp_path / tag).mkdir()
        outs = [str(tmp_path / tag / n) for n in ("out_n", "out_a")]
        assert main(["guidedassembleresult", *ins, *outs,
                     "--max-seq-len", "300"]) == 0
    assert same_outputs(tmp_path / "port", tmp_path / "jax") >= 2
    assert AlnDB.load(str(tmp_path / "aln")).qkey.size
    assert SeqDB.load(str(tmp_path / "port" / "out_n")).ext.any()
