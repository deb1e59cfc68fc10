"""Generators, one module a kind of input (a traffic file's ``kind``).

A generator module defines ``make(traffic, config, g, device)``: the
cell's inputs, a dict of tensors on ``device``, drawn from the seeded
``torch.Generator`` ``g`` by the traffic file's parameters at the
configuration's sizes. The entry and the check read them by name.
"""
