"""The classical baseline the paper compares against (JAX package
`baselines/`): word-level Huffman source coding, a rate-1/3 turbo code with
an iterative max-log-MAP (BCJR) decoder on the device, Gray M-QAM with
max-log LLR demapping, and the BLEU-vs-SNR sweep around them."""
