"""FASTA / CLUSTAL / MAF parsers and example loading.

Behavioural equivalent of the reference's streaming loaders
(stem_kernel/common/fa.cpp:59-154, common/aln.cpp:16-120,
common/maf.cpp:15-50) and its file-type sniffing
(stem_kernel/stem_kernel_lite/data.cpp:458-480): the first
significant line decides the format ('>' -> FASTA, 'CLUSTAL' -> ALN,
'a ' -> MAF).

One *example* is an :class:`Alignment` — a list of equal-length (gapped)
sequence strings.  A FASTA file yields one single-row alignment per record;
a CLUSTAL file yields one multi-row alignment per CLUSTAL section; a MAF file
yields one multi-row alignment per ``a`` paragraph.  Glob patterns in file
arguments are expanded like the reference's Glob wrapper
(stem_kernel/common/glob_wrapper.h:11-40).
"""

from __future__ import annotations

import glob as _glob
from dataclasses import dataclass, field
from enum import Enum
from typing import Iterator, Sequence

from .profile import Alignment


class FileType(Enum):
    UNKNOWN = 0
    FASTA = 1
    ALN = 2
    MAF = 3


def sniff_filetype(path: str) -> FileType:
    """Decide file format from the first recognizable line."""
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                return FileType.FASTA
            if line.startswith("CLUSTAL") or line.startswith("PROBCONS"):
                return FileType.ALN
            if line.startswith("a ") or line.startswith("##maf"):
                return FileType.MAF
    return FileType.UNKNOWN


def parse_fasta(text: str) -> list[tuple[str, str]]:
    """Parse FASTA text into (name, sequence) records."""
    records: list[tuple[str, str]] = []
    name = None
    chunks: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                records.append((name, "".join(chunks)))
            name = line[1:].strip()
            chunks = []
        elif name is not None:
            chunks.append(line)
    if name is not None:
        records.append((name, "".join(chunks)))
    return records


def parse_clustal(text: str) -> list[list[tuple[str, str]]]:
    """Parse CLUSTAL text into alignments (one per CLUSTAL header section).

    Interleaved blocks with consistent row names are concatenated per row
    (aln.cpp push_seq/reset_index semantics, including the length-consistency
    check).
    """
    alignments: list[list[tuple[str, str]]] = []
    names: list[str] = []
    seqs: list[str] = []
    cur = 0

    def flush_section() -> None:
        nonlocal names, seqs, cur
        if names:
            alignments.append(list(zip(names, seqs)))
        names, seqs, cur = [], [], 0

    in_section = False
    for line in text.splitlines():
        if line.startswith("CLUSTAL") or line.startswith("PROBCONS"):
            flush_section()
            in_section = True
            continue
        if not in_section:
            continue
        stripped = line.strip()
        if not stripped:
            cur = 0
            continue
        # conservation/status lines consist only of "*:." and blanks
        if all(c in "*:. \t" for c in stripped):
            cur = 0
            continue
        parts = stripped.split()
        if len(parts) < 2:
            continue
        rname, rseq = parts[0], parts[1]
        if cur >= len(names):
            names.append(rname)
            seqs.append(rseq)
        elif names[cur] == rname:
            seqs[cur] += rseq
        else:
            raise ValueError("CLUSTAL format error: broken sequence name consistency")
        cur += 1
    flush_section()
    for aln in alignments:
        lengths = {len(s) for _, s in aln}
        if len(lengths) > 1:
            raise ValueError("CLUSTAL format error: broken sequence length consistency")
    return alignments


def parse_maf(text: str) -> list[list[tuple[str, str]]]:
    """Parse MAF text into alignments (one per ``a`` paragraph)."""
    alignments: list[list[tuple[str, str]]] = []
    current: list[tuple[str, str]] | None = None
    for line in text.splitlines():
        if line.startswith("a"):
            if current:
                alignments.append(current)
            current = []
        elif line.startswith("s ") and current is not None:
            # s name start size strand srcSize text
            parts = line.split()
            if len(parts) >= 7:
                current.append((parts[1], parts[6]))
        elif not line.strip():
            if current:
                alignments.append(current)
                current = None
    if current:
        alignments.append(current)
    return alignments


def iter_alignments(path: str) -> Iterator[Alignment]:
    """Stream examples from a file, one :class:`Alignment` at a time."""
    ftype = sniff_filetype(path)
    with open(path) as f:
        text = f.read()
    if ftype == FileType.FASTA:
        for name, seq in parse_fasta(text):
            yield Alignment(rows=[seq], names=[name])
    elif ftype == FileType.ALN:
        for aln in parse_clustal(text):
            yield Alignment(rows=[s for _, s in aln], names=[n for n, _ in aln])
    elif ftype == FileType.MAF:
        for aln in parse_maf(text):
            yield Alignment(rows=[s for _, s in aln], names=[n for n, _ in aln])
    else:
        raise ValueError(f"{path}: unknown file format")


def expand_globs(patterns: Sequence[str]) -> list[str]:
    """Expand shell glob patterns, preserving order; literal names pass through."""
    out: list[str] = []
    for pat in patterns:
        matches = sorted(_glob.glob(pat))
        out.extend(matches if matches else [pat])
    return out


@dataclass
class LabeledExamples:
    """A labeled data set: one label per alignment (framework.h load_examples)."""

    alignments: list[Alignment] = field(default_factory=list)
    labels: list[str] = field(default_factory=list)


def load_examples(label_files: Sequence[tuple[str, str]]) -> LabeledExamples:
    """Load (label, file-or-glob) pairs into a flat example list.

    Mirrors App::load_examples (stem_kernel/common/framework.h:308-353):
    each file contributes all of its alignments under the given label.
    """
    ex = LabeledExamples()
    for label, pattern in label_files:
        for path in expand_globs([pattern]):
            for aln in iter_alignments(path):
                ex.alignments.append(aln)
                ex.labels.append(label)
    return ex
