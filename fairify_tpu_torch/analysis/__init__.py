"""Post-verification analysis (port of ``fairify_tpu/analysis``): the group
fairness metrics (:mod:`metrics`), biased-neuron localization
(:mod:`localize`), repair (:mod:`repair`), hybrid routing (:mod:`hybrid`),
causal discrimination (:mod:`causal`) and the experiment pipeline over them
(:mod:`experiment`)."""
