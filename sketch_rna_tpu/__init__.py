"""sketch_rna_tpu — accelerator-native RNA-seq isoform quantification engine.

A from-scratch JAX/XLA/Pallas re-architecture of the alignment-free
FracMinHash sketch -> candidate matching -> EM quantification pipeline of
the reference C++ tool (Codfishz/Sketch-for-RNA-seq, see SURVEY.md).

Layer map (mirrors SURVEY.md §7.2):
  io/      host-side FASTA/FASTQ parsing, validation, 2-bit packing
           (reference: src/data_io.cpp, src/main.cpp:107-151)
  hash/    ntHash2 forward rolling hash, vectorised
           (reference: nthash library usage at src/sketch.cpp:31-37)
  sketch/  FracMinHash threshold + set dedup (reference: src/sketch.cpp:24-39)
  index/   device-built inverted index as sorted keys + CSR postings
           (reference: src/sketch.cpp:51-74, src/data_io.cpp:165-304)
  match/   candidate matching ("sparse chaining")
           (reference: src/sparse_chaining.cpp:29-115)
  em/      EM abundance + soft read assignment
           (reference: src/isoform_assignment.cpp:9-97)
  dist/    jax.sharding mesh / shard_map multi-chip pipeline (new; the
           reference is single-threaded, SURVEY.md §2 parallelism inventory)
  oracle/  pure-NumPy scalar implementation of the exact reference math,
           used as the golden model in tests (SURVEY.md §4)
"""

__version__ = "0.1.0"

from sketch_rna_tpu.config import QuantConfig  # noqa: F401
