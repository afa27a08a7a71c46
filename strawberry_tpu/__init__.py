"""strawberry_tpu: RNA-seq transcript assembly & quantification in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of
ruolin/strawberry 1.1.2: genome-guided isoform assembly (splice graph +
constrained minimum path cover) and latent-class-model EM quantification
from position-sorted BAM alignments, re-designed for an accelerator — loci
become batched padded tensor problems, hosts shard the genome, and the
global TPM reduction rides collectives.
"""
__version__ = "0.1.0"

from .config import Config

__all__ = ["Config"]
