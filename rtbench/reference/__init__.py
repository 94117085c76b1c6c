"""The benchmark's yardstick: the plain reference renderer, the sampler
it draws from, the camera arithmetic and the frozen bound arithmetic.
Nothing here imports the program."""
