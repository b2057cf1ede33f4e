from repro_torch.data.federated import (  # noqa: F401
    FederatedDataset, char_lm_federated, pack_clients,
    pseudo_femnist_federated, pseudo_mnist_federated,
)
from repro_torch.data.synthetic import syncov, synlabel  # noqa: F401
