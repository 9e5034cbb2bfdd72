"""Volume generators, each made on the device from a seed; a
configuration names its generator by module name."""
