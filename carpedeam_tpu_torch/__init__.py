"""carpedeam_tpu_torch — the carpedeam assembler on PyTorch and CUDA.

The port of the JAX package `carpedeam_tpu` (which stays the reference)
to an NVIDIA H100.  The host stages (native C++ k-mer matching, greedy
splicing, contig merging, linclust) are the JAX package's own host code,
copied; the four Pallas kernels of the default ancient_assemble path are
hand-written CUDA C++ for sm_90a (csrc/), built by one nvcc call and
loaded with ctypes (_build.py).

Layer map:
  io/       sequence database (packed arrays), FASTA/FASTQ ingest
  kmer/     k-mer packing, xxh64 subsampling, host kmermatcher
  ops/      device planes and the kernel wrappers (*_cuda.py), each with
            a plain PyTorch version used for CPU tensors
  ops/coding_mlp  the kerasify coding MLP (nn.Linear layers)
  stages/   pipeline stages (host oracles and splicing) and the
            protein-guided extension (guided_assembly)
  parallel/ multi-process ranks (CARPEDEAM_RANK/WORLD, --world) and the
            device-sharded stages (--use-device mesh)
  pipeline  the nuclassemble / ancient_assemble drivers
  cli       every command of the JAX package's CLI: ancient_assemble,
            nuclassemble and the stage subcommands on saved DBs
"""

__version__ = "0.1.0"
