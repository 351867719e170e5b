"""Signal files without basecall events: the runner must fall back to
raw-signal kmer-event alignment (upstream test_signal_files_without_events,
test_runSignalAlign.py:196-211)."""

import glob
import os
import shutil

import h5py
import pytest

from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline.runner import run_signal_align

NOEV_DIR = "/root/reference/tests/minion_test_reads/no_event_data_1D_ecoli"
ONED_BAM = "/root/reference/tests/minion_test_reads/oneD.bam"
MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


def test_no_event_read_aligns(tmp_path, ecoli_fasta):
    # pick the no-events fast5 for read 5cc86bac (no Analyses group at all)
    src = None
    for p in glob.glob(NOEV_DIR + "/*.fast5"):
        with h5py.File(p, "r") as fh:
            rid = None
            for k in fh.get("Raw/Reads", {}):
                rid = fh[f"Raw/Reads/{k}"].attrs.get("read_id")
            if rid is not None and rid.decode().startswith("5cc86bac"):
                assert "Analyses" not in fh or not list(fh["Analyses"])
                src = p
    assert src
    f5dir = tmp_path / "reads"
    f5dir.mkdir()
    dst = f5dir / os.path.basename(src)
    shutil.copy(src, dst)
    readdb = tmp_path / "reads.readdb"
    with open(readdb, "w") as fh:
        fh.write("5cc86bac-79fd-4897-8631-8f1c55954a45_Basecall_Alignment_"
                 f"template:1D_000:template\t{os.path.basename(src)}\n")

    model = PoreModel.from_file(MODEL)
    out = run_signal_align(
        alignment_file=ONED_BAM, readdb=str(readdb), fast5_dirs=[str(f5dir)],
        reference_fasta=ecoli_fasta, model=model,
        output_dir=str(tmp_path / "out"), verbose=True)
    assert len(out) == 1
    lines = open(out[0]).read().strip("\n").split("\n")
    # event table was generated: output row count in the reference's bounds
    assert len(lines) > 5000
    # property: output kmers equal the reference slice
    ref = {}
    with open(ecoli_fasta) as fh:
        name = None
        for line in fh:
            if line.startswith(">"):
                name = line[1:].split()[0]
                ref[name] = []
            else:
                ref[name].append(line.strip())
    seq = "".join(ref["gi_ecoli"])
    for line in lines[:200] + lines[-200:]:
        parts = line.split("\t")
        pos, kmer = int(parts[1]), parts[2]
        assert seq[pos:pos + 5] == kmer
    # the generated event table was embedded back into the fast5
    with h5py.File(dst, "r") as fh:
        assert "Analyses/SignalAlign_Basecall_1D_000/BaseCalled_template/" \
            "Events" in fh
