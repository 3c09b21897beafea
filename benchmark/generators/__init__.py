"""Data generators, one module a configuration's `generator`: each has
`make(config, seed, device) -> (train Split, valid Split)`, drawn on the
device from one torch.Generator seeded with the run's seed, with a
labelling function that does not depend on the seed."""
