"""Structure converters: PDBx/mmCIF files and AF2-multimer labels into the
condensed HDF5 files the protein configs train on (``mmcif``,
``af2_multimer``), run as ``python -m
equivariant_nn_zoo_tpu_torch.data_processing.<name>``."""
