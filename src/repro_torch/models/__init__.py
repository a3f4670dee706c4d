"""The paper's FEMNIST CNN and the small MLP, in the reference's layouts."""
