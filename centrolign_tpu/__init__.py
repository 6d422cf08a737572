"""centrolign_tpu: a tandem-repeat MSA engine with its DP on an accelerator.

A from-scratch reimplementation of the capabilities of jeizenga/centrolign
(progressive guide-tree MSA of megabase tandem-repeat DNA over sequence DAGs):
host Python/C++ orchestrates graphs, trees, and I/O while the
dynamic-programming inner loops (graph-graph Gotoh / PO-POA, sparse anchor
chaining) run as anti-diagonal wavefront JAX/Pallas kernels.

Reference behavior parity is documented per-module with file:line citations
into the reference source tree (see SURVEY.md).
"""

__version__ = "0.1.0"

from .graph import BaseGraph
from .alignment import GAP, cigar, explicit_cigar

__all__ = ["BaseGraph", "GAP", "cigar", "explicit_cigar", "__version__"]
