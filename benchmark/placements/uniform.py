"""``uniform``: agents uniform over the world's interior, ``margin``
metres inside each edge."""

import torch


def positions(config, spec: dict, n: int, seed: int, device):
    g = config.grid
    half = torch.tensor([g.width / 2 - spec["margin"],
                         g.height / 2 - spec["margin"]], dtype=config.tdtype,
                        device=device)
    centre = torch.tensor([g.offset[0] + g.width / 2,
                           g.offset[1] + g.height / 2], dtype=config.tdtype,
                          device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((n, 2), generator=gen, device=device, dtype=config.tdtype)
    return (u * 2.0 - 1.0) * half + centre
