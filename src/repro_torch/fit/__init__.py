"""The Alg. 1 fit: state, streaming top-K affinity and the round body."""
