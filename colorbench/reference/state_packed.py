"""The program's bit-packed adjacency judged against the reference's
edges: the bits in which it differs (``hashgraph.adjacency_wrong_bits``)."""

from colorbench.reference.hashgraph import adjacency_wrong_bits


def errors(words, src, dst, n: int) -> int:
    return adjacency_wrong_bits(words, src.to(words.device), dst.to(words.device))
