"""The analysis layer: RSA and probing, regressions, figures.

Mirrors peppa_tpu/analysis/.  Host work in numpy, with pandas, scipy,
sklearn, matplotlib and Levenshtein imported inside the functions that use
them; the model side of `grsa` (`Embedder`, `pairwise`,
`embed_utterances`) runs the port's audio tower on the card.
"""
