"""Flash attention forward: online softmax with GQA, causal end alignment,
sliding window and logit softcap."""
