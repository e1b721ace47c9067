"""The plain reference of the benchmark: IRLI's query path (Alg. 2) over a
block-scaled int8 store, written with plain PyTorch operations, computed in
float32 with TF32 off. It imports nothing of the program and takes none of
its state: it builds the member lists and the int8 codes from the inputs
the harness hands it."""
