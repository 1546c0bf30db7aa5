"""LM model zoo: the serving path (prefill + cached decode) of every
architecture of the registry, the port of :mod:`repro.models`.

Parameters are declared once as :class:`repro_torch.models.param.ParamDef`
trees laid out as the JAX package lays them out (period positions stacked
over a leading ``layers`` axis), so shapes, counts and the carrying-across of
JAX weights compare leaf by leaf.  At run time the model is an
``nn.Module`` (:class:`repro_torch.models.transformer.DecoderLM`) whose
blocks sit in layer order in an ``nn.ModuleList``, with the JAX leaf names
and layouts.  The LM path has no CUDA kernel: the JAX package's LM path
reaches no Pallas kernel either.
"""
