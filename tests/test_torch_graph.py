"""Stage 05 of the port (nextdenovo_tpu_torch/graph/) against the JAX
package's: the same OvlBlock and `bl` dict go into both `assemble`s.
Tolerance: exact equality of contigs, paths and node metadata, and
byte-identical output files."""
import json

import numpy as np
import pytest

from nextdenovo_tpu.graph import assemble as jg
from nextdenovo_tpu.graph import output as jo
from nextdenovo_tpu.io.seqstore import SeqStore as JStore
from nextdenovo_tpu.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu.overlap.records import OvlBlock as JBlock
from nextdenovo_tpu_torch import convert
from nextdenovo_tpu_torch.graph import assemble as tg
from nextdenovo_tpu_torch.graph import output as to
from nextdenovo_tpu_torch.overlap.cns import cns_overlap_stage

GLEN = 20_000


@pytest.fixture(scope="module")
def graph_input():
    """Dovetail overlaps and per-read graph info of ~1 % error reads, made
    by the port's stage 04 on the CPU and handed to both sides."""
    g = simulate_genome(GLEN, seed=41)
    sim = simulate_reads(g, coverage=8, mean_len=3000, error_rate=0.01,
                         seed=42)
    js = JStore.from_codes(sim.reads)
    ts = convert.seqstore_from_arrays(js.words, js.word_start, js.length,
                                      js.names)
    blk, bl = cns_overlap_stage(ts, np.arange(len(ts)), k=17, w=17,
                                min_span=300, device="cpu")
    assert len(blk) > 20 and len(bl) > 5
    cols = {k: np.asarray(v) for k, v in blk.data.items()}
    # the dict as the pipeline reloads it from cnsbl.json
    bl = {int(k): v for k, v in json.loads(json.dumps(bl)).items()}
    return js, ts, JBlock.from_arrays(**cols), blk, bl


def _run(mod, store, blk, bl, use_native):
    read_lens = {i: int(store.length[i]) for i in range(len(store))}
    return mod.assemble(blk, read_lens, bl_info=bl,
                        get_read=lambda r: store.get(r), min_ctg_len=1000,
                        use_native=use_native, sbranch_len=2)


@pytest.mark.parametrize("use_native", [None, False],
                         ids=["native", "python"])
def test_assemble_equal(graph_input, use_native):
    js, ts, jblk, tblk, bl = graph_input
    jsg, jseqs = _run(jg, js, jblk, bl, use_native)
    tsg, tseqs = _run(tg, ts, tblk, bl, use_native)
    assert len(tseqs) >= 1 and len(tseqs[0]) > 0.5 * GLEN
    assert len(jseqs) == len(tseqs)
    for a, b in zip(jseqs, tseqs):
        assert np.array_equal(a, b)
    # a path is a list of (node, Edge): the two Edge classes differ, their
    # fields must not
    assert repr(jsg.last_paths) == repr(tsg.last_paths)
    assert json.dumps(jsg.last_node_meta, default=int, sort_keys=True) == \
        json.dumps(tsg.last_node_meta, default=int, sort_keys=True)


@pytest.mark.parametrize("writer", ["fasta", "gfa", "graphml", "paths"])
def test_writers_byte_identical(graph_input, tmp_path, writer):
    js, ts, jblk, tblk, bl = graph_input
    outs = []
    for tag, mod, out, store, blk in (("j", jg, jo, js, jblk),
                                      ("t", tg, to, ts, tblk)):
        sg, seqs = _run(mod, store, blk, bl, None)
        p = str(tmp_path / f"{tag}.{writer}")
        if writer == "fasta":
            out.write_ctg_fasta(p, sg, seqs, sg.last_paths, min_len=1000,
                                node_meta=sg.last_node_meta)
        elif writer == "gfa":
            out.write_ctg_gfa(p, sg, seqs, sg.last_paths)
        elif writer == "graphml":
            out.write_graphml(p, sg)
        else:
            out.write_ctg_paths(p, sg, sg.last_paths)
        outs.append(open(p, "rb").read())
    assert len(outs[0]) > 0
    assert outs[0] == outs[1]


def test_stat_table_and_header_round_trip(graph_input):
    js, ts, jblk, tblk, bl = graph_input
    sg, seqs = _run(tg, ts, tblk, bl, None)
    assert to.stat_table(seqs, GLEN) == jo.stat_table(seqs, GLEN)
    meta = sg.last_node_meta[0]
    assert to.pack_node_qv(meta) == jo.pack_node_qv(meta)
    assert to.classify_path(sg, sg.last_paths[0]) == \
        jo.classify_path(sg, sg.last_paths[0])
