"""The models the PreSto pipeline trains: the DLRM of the paper's Table I."""
