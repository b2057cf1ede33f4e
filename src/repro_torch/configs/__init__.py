from repro_torch.configs.paper_models import PAPER_NETS, PaperNetConfig  # noqa: F401
